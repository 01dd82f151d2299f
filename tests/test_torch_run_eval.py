"""The port's standalone generative eval (``rqvae_tpu_torch.evaluate.run_eval``)
on the CPU.

The offline path end to end at a tiny size: a raw Amazon fixture through
the port's preprocessor, a port stage-1 run and a port decoder run on its
artifacts (``device="cpu"``), then ``evaluate_checkpoint`` on the test and
eval splits and ``main``'s JSON line.

The parity case evaluates one JAX-initialised RQ-VAE and decoder in both
packages on one processed fixture: JAX from its own checkpoints, the port
from the same leaves (``convert.from_numpy``) saved as port checkpoints,
with exhaustive candidates (no noise to match). The metric dicts must be
equal to 1e-6, with h@10 > 0 and no two of a user's top-10 beam scores
within 1e-5 of each other (``torch.topk`` and ``jax.lax.top_k`` order
equal scores differently).
"""
import dataclasses
import gzip
import json
import math
import shutil

import jax
import numpy as np
import pytest
import torch

from rqvae_tpu.evaluate import run_eval as jrun_eval
from rqvae_tpu.models import retrieval as jret
from rqvae_tpu.models import rqvae as jrq
from rqvae_tpu.train import checkpoint as jckpt
from rqvae_tpu.train import train_decoder as jtd
from rqvae_tpu.utils import config as jconfig
from rqvae_tpu_torch.data import amazon as tamazon
from rqvae_tpu_torch.data.text import hashed_stub_encoder
from rqvae_tpu_torch.evaluate import run_eval
from rqvae_tpu_torch.models import convert
from rqvae_tpu_torch.train import checkpoint as tckpt
from rqvae_tpu_torch.train import train_decoder as ttd
from rqvae_tpu_torch.train import train_rqvae as ttr
from rqvae_tpu_torch.utils import config as tconfig
from rqvae_tpu_torch.utils.logging import MetricsLogger

FEAT = 16


def _amazon_fixture(root, *, n_items, n_users, seed, lo=4, hi=13):
    """A raw Amazon split from a numpy seed, processed by the port (the
    stub encoder at FEAT dims). Returns the dataset root."""
    raw = root / "raw" / "beauty"
    raw.mkdir(parents=True)
    rng = np.random.RandomState(seed)
    lines = [" ".join(map(str, [u, *rng.randint(1, n_items + 1, rng.randint(lo, hi))]))
             for u in range(1, n_users + 1)]
    (raw / "sequential_data.txt").write_text("\n".join(lines) + "\n")
    (raw / "datamaps.json").write_text(
        json.dumps({"item2id": {f"A{i}": str(i) for i in range(1, n_items + 1)}}))
    with gzip.open(raw / "meta.json.gz", "wt") as f:
        for i in range(1, n_items + 1):
            f.write(repr({"asin": f"A{i}", "title": f"item {i}", "brand": f"b{i % 5}",
                          "categories": [["Beauty", f"c{i % 3}"]], "price": float(i)}) + "\n")
    tamazon.process(str(root), "beauty", encode_fn=hashed_stub_encoder(dim=FEAT))
    return str(root)


VAE = dict(dataset="AMAZON", dataset_split="beauty", vae_input_dim=FEAT, vae_hidden_dims=(16,),
           vae_embed_dim=8, vae_codebook_size=16, vae_n_cat_feats=0, vae_n_layers=3,
           vae_codebook_mode="ROTATION_TRICK", seed=0)


class Quiet(MetricsLogger):
    def __init__(self):
        super().__init__(every=1)

    def log(self, step, metrics, force=False):
        pass


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Port preprocessing, stage 1 and the decoder on the CPU; the decoder
    keeps checkpoints at steps 4 and 9."""
    tmp = tmp_path_factory.mktemp("offline")
    root = _amazon_fixture(tmp, n_items=60, n_users=80, seed=0)
    rq_cfg = tconfig.from_dict(ttr.RqVaeTrainConfig, dict(
        VAE, data_path=root, iterations=16, batch_size=32, eval_every=10**9,
        save_model_every=10**9, save_dir_root=str(tmp / "rq"), log_every=100,
        kmeans_prime_items=40, steps_per_call=4))
    ttr.train(rq_cfg, logger=Quiet(), device="cpu")
    cfg = tconfig.from_dict(ttd.DecoderTrainConfig, dict(
        VAE, data_path=root, iterations=10, batch_size=8, learning_rate=1e-3,
        pretrained_rqvae_path=str(tmp / "rq"), save_dir_root=str(tmp / "dec"), attn_embed_dim=32,
        attn_heads=2, attn_layers=2, decoder_embed_dim=8, dropout_p=0.1, log_every=100,
        partial_eval_every=0, full_eval_every=10**9, save_model_every=5, eval_batches=1,
        warmup_steps=10, generation_top_k=8, generation_candidates=16))
    ttd.train(cfg, logger=Quiet(), device="cpu")
    return cfg


def _check_metrics(m, split, n_users, step):
    assert m["split"] == split and m["n_users"] == n_users and m["checkpoint_step"] == step
    assert {"h@1_slice_:4", "h@5_slice_:4", "h@10_slice_:4", "ndcg@10"} <= set(m)
    assert all(0.0 <= v <= 1.0 for k, v in m.items() if k.startswith(("h@", "ndcg")))


def test_evaluate_checkpoint_on_the_test_split(trained):
    assert tckpt.latest_step(trained.save_dir_root) == 9
    m = run_eval.evaluate_checkpoint(trained, split="test", max_users=24, device="cpu")
    _check_metrics(m, "test", 24, 9)
    # every user of the split, and an earlier step of the run
    _check_metrics(run_eval.evaluate_checkpoint(trained, split="eval", step=4, device="cpu"),
                   "eval", 80, 4)


def test_main_prints_one_json_line(trained, tmp_path, capsys):
    config = tmp_path / "decoder.json"
    config.write_text(json.dumps(tconfig.config_to_dict(
        dataclasses.replace(trained, save_dir_root=str(tmp_path / "elsewhere")))))
    run_eval.main([str(config), "--split", "test", "--checkpoint", trained.save_dir_root,
                   "--max-users", "16", "--seed", "3", "--device", "cpu", "batch_size=4"])
    lines = capsys.readouterr().out.strip().splitlines()
    m = json.loads(lines[-1])
    _check_metrics(m, "test", 16, 9)


def test_sampled_candidates_draw_from_the_seed(trained):
    cfg = dataclasses.replace(trained, generation_candidates=6)
    a, b, c = (run_eval.evaluate_checkpoint(cfg, split="test", max_users=16, seed=s, device="cpu")
               for s in (1, 1, 2))
    assert a == b
    _check_metrics(c, "test", 16, 9)


def test_refusals(trained, tmp_path, monkeypatch):
    # a model axis is accepted (the parameters stay whole), but (1, 2) does
    # not cover a world of one; a model axis over ranks: test_torch_tensor_parallel.py
    with pytest.raises(ValueError, match=r"mesh_shape \(1, 2\) does not cover"):
        run_eval.evaluate_checkpoint(dataclasses.replace(trained, mesh_shape=(1, 2),
                                                         tensor_parallel=True), device="cpu")
    # artifacts without a test split
    shutil.copytree(f"{trained.data_path}/processed_beauty", tmp_path / "processed_beauty")
    (tmp_path / "processed_beauty" / "seqs_test.npz").unlink()
    with pytest.raises(SystemExit, match="no 'test' sequences"):
        run_eval.evaluate_checkpoint(dataclasses.replace(trained, data_path=str(tmp_path)),
                                     split="test", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_eval.evaluate_checkpoint(trained, split="test")


def test_metrics_equal_jax_on_the_same_parameters(tmp_path, monkeypatch):
    root = _amazon_fixture(tmp_path / "data", n_items=12, n_users=40, seed=1, lo=4, hi=9)
    fields = dict(VAE, data_path=root, batch_size=8, attn_embed_dim=32, attn_heads=2,
                  attn_layers=2, decoder_embed_dim=8, dropout_p=0.0, generation_top_k=10,
                  generation_candidates=16)
    jcfg = jconfig.from_dict(jtd.DecoderTrainConfig, dict(
        fields, pretrained_rqvae_path=str(tmp_path / "jrq"), save_dir_root=str(tmp_path / "jdec")))
    tcfg = tconfig.from_dict(ttd.DecoderTrainConfig, dict(
        fields, pretrained_rqvae_path=str(tmp_path / "trq"), save_dir_root=str(tmp_path / "tdec")))
    rq = jax.device_get(jrq.init(jax.random.PRNGKey(5), jcfg.vae_config()))
    dec = jax.device_get(jret.init(jax.random.PRNGKey(1), jcfg.retrieval_config(20)))
    jckpt.save(jcfg.pretrained_rqvae_path, 0, {"params": rq})
    jckpt.save(jcfg.save_dir_root, 7, {"params": dec})
    tckpt.save(tcfg.pretrained_rqvae_path, 0, {"params": convert.from_numpy(rq, device="cpu")})
    tckpt.save(tcfg.save_dir_root, 7, {"params": convert.from_numpy(dec, device="cpu")})

    want = jrun_eval.evaluate_checkpoint(jcfg, split="test")
    scores = []
    real = ttd.generation.generate_next_sem_ids

    def recording(*a, **kw):
        out = real(*a, **kw)
        scores.append(out.log_probas)
        return out

    monkeypatch.setattr(ttd.generation, "generate_next_sem_ids", recording)
    got = run_eval.evaluate_checkpoint(tcfg, split="test", device="cpu")

    assert set(got) == set(want)
    assert got["split"] == "test" and got["n_users"] == want["n_users"] == 40
    assert got["checkpoint_step"] == want["checkpoint_step"] == 7
    for key, value in want.items():
        if key.startswith(("h@", "ndcg")):
            assert math.isclose(got[key], float(value), abs_tol=1e-6), (key, got[key], value)
    assert got["h@10_slice_:4"] > 0
    # the beams' order is defined: no two top-10 scores of a user within 1e-5
    top = torch.cat(scores)[:40]
    gaps = (top[:, :-1] - top[:, 1:]).min()
    assert top.shape == (40, 10) and float(gaps) > 1e-5, float(gaps)
