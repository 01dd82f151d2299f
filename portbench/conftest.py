"""Test settings of the benchmark's own tests (``portbench/tests``), which
``python -m pytest portbench/tests`` runs; the repository's ``pytest tests/``
does not collect them. Tests that need an NVIDIA card carry the ``card``
marker and take the ``card`` fixture, which skips them where no card is
visible: the decision is made when the test runs, never at import."""
import copy

import pytest

from portbench import spec

# The ML-32M training cell: its configuration, mix and limits are files of
# the benchmark, kept for the change that adds the cell to BENCHMARK.json
# (left out there for the spread of its rate); the tests run it as that
# change would add it, by these entries alone.
KEPT_CONFIG = {"name": "decoder_ml32m", "source": "https://github.com/AdamLTy/RQ-VAE-Recommender",
               "file": "portbench/configs/decoder_ml32m.json", "reduced": [],
               "why": "the shipped ML-32M decoder"}
KEPT_CELL = {"name": "ml32m_train", "config": "decoder_ml32m", "traffic": "train_ml32m", "chips": 1,
             "why": "batch 64 of 200-item crops (801 tokens), 2 length buckets, closed loop"}


def bench_with_kept() -> dict:
    """BENCHMARK.json with the kept ML-32M training cell added."""
    bench = copy.deepcopy(spec.benchmark())
    bench["configs"].append(dict(KEPT_CONFIG))
    bench["workloads"].append(dict(KEPT_CELL))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "amazon_train" in m.get("workloads", ()):
            m["workloads"].append(KEPT_CELL["name"])
    return bench


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; none is visible")
    return torch.device("cuda", 0)


def _tiny(ctx):
    """Cut a cell to a size the CPU tests run in seconds (the widths of the
    kernels' routes kept: 64-wide heads)."""
    c, m = ctx.config, ctx.traffic
    c["decoder"].update(attn_embed_dim=128, attn_heads=2, attn_layers=2, decoder_embed_dim=32)
    if m["kind"] == "serve":
        for d in (c["rqvae"], c["decoder"]):
            d.update(vae_input_dim=48, vae_hidden_dims=[32, 16], vae_embed_dim=8)
        c["n_items"] = 3000
        m.update(batch=16, warmup_calls=1, check_calls=2)
        m["history"]["users"] = 200
    else:
        c["decoder"]["vae_codebook_size"] = 16
        c["max_seq_len"] = 24
        c["n_items"] = 500
        m.update(batch=8, warmup_steps=1)
        m["history"]["users"] = 60
        if "ratings" in m["history"]:
            m["history"].update(ratings=2400, least=5, window=24, stride=20)


@pytest.fixture
def run_tiny(capsys, monkeypatch):
    """Run a cell (the kept one too) on the CPU at a tiny size through
    ``run.main``; returns (exit code, the result line as a dict or None)."""
    import json

    import torch

    from portbench import run

    bench = bench_with_kept()
    monkeypatch.setattr(spec, "benchmark", lambda root=spec.ROOT: bench)

    def go(cell, seed=2**31 + 77):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.3", "--trace", "0"],
                      device=torch.device("cpu"), adjust=_tiny)
        lines = capsys.readouterr().out.strip().splitlines()
        return rc, (json.loads(lines[-1]) if lines and lines[-1].startswith("{") else None)

    return go
