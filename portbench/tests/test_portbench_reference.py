"""The reference against the port's plain CPU routes at a tiny size: a
whole run of each cell (set-up, window, check) through ``run.main`` with
the look for a card skipped; and the reference's parts on their own."""
import numpy as np
import pytest
import torch

from portbench import traffic
from portbench.conftest import bench_with_kept
from portbench.reference import corpus, train

CELLS = [w["name"] for w in bench_with_kept()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_run_agrees_with_reference(cell, run_tiny):
    rc, result = run_tiny(cell)
    assert rc == 0 and result["correct"], result
    for name, c in result["checks"].items():
        assert c["value"] <= max(1e-5, c["limit"] * 1e-2), (name, c)
    assert result["attempted"] > 0


def test_buckets_match_the_ports():
    from rqvae_tpu_torch.train.train_decoder import bucket_slices

    lengths = np.random.default_rng(0).integers(1, 200, 64)
    for n in (1, 2, 4):
        ours = train.buckets(lengths, n)
        theirs = bucket_slices(lengths, n)
        assert all((a == c).all() and b == d for (a, b), (c, d) in zip(ours, theirs))


def test_dedup_and_prefixes():
    codes = torch.tensor([[1, 2, 3], [1, 2, 3], [0, 0, 1], [1, 2, 3], [0, 0, 1]])
    assert corpus.dedup(codes).tolist() == [0, 1, 0, 2, 1]
    assert traffic.dedup_column(codes.numpy()).tolist() == [0, 1, 0, 2, 1]
    tuples = torch.cat([codes, corpus.dedup(codes)[:, None]], dim=1)
    pre = corpus.Prefixes(tuples, 4)
    ok = pre.allowed(torch.tensor([[1, 2], [0, 0], [3, 3]]))
    assert ok[0].tolist() == [False, False, False, True] and ok[1].tolist() == [False, True, False, False]
    assert not ok[2].any()
    assert pre.contains(torch.tensor([[1, 2, 3, 2], [1, 2, 3, 3]])).tolist() == [True, False]


def test_near_ties_are_adopted_and_other_differences_counted():
    g = torch.Generator().manual_seed(1)
    items = torch.randn(64, 12, generator=g)
    rq = {"vae_input_dim": 12, "vae_hidden_dims": [10], "vae_embed_dim": 6,
          "vae_codebook_size": 8, "vae_n_layers": 2}
    params = corpus.init_rqvae(g, rq, items)
    codes, bad = corpus.tokenize(params, items)
    assert bad == 0
    again, bad = corpus.tokenize(params, items, codes)
    assert bad == 0 and torch.equal(again, codes)
    wrong = codes.clone()
    wrong[0, 0] = (wrong[0, 0] + 1) % 8
    _, bad = corpus.tokenize(params, items, wrong)
    assert bad == 1
