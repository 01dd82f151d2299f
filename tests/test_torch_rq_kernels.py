"""The quantizer kernels' design (``csrc/rq_common.cuh``), emulated on the CPU.

The CUDA kernel runs only on the GPU, where ``chip_smoke.py`` holds it
against its twin. Here a torch emulation of its order of operations is held
against the plain twins (``rq_tokenize_plain``, ``rq_quantize_train_plain``)
and against JAX's Pallas kernels in interpret mode, as the JAX package's own
tests run them on the CPU:

* the launch plan (``quantize_kernels.plan``, the library's rule restated):
  rows a cluster, CTAs a cluster, each CTA's slice of every level's codes,
  tiles and stages (all levels resident, or a ring);
* each CTA scores its slice, tile by tile, each warp its 16-code chunks,
  with ||cb||^2 summed from the staged codes in an order that does not
  depend on where a code sits (8 lanes, chunks p, p + 8, ..., a butterfly);
* the per-warp minima merge over the warps, then over the cluster's CTAs,
  by (distance, index): lowest index on equal distances; a row whose every
  distance is NaN takes code 0.

Ids must equal off near-ties (top-2 gap < 1e-5 relative), values within
1e-5. The route test checks that the port's stage-1 training takes the
fused kernel at the Amazon widths.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.ops import quantize_pallas
from rqvae_tpu_torch.models import rqvae
from rqvae_tpu_torch.ops import quantize_kernels as qk

INT_MAX = 2**31 - 1
BETA = 0.25


def _lexmin(dist, codes):
    """(distance, code) minimum of each row over the columns: the smaller
    distance, the lower code on equal ones; NaN never wins (no winner:
    (inf, INT_MAX))."""
    valid = ~torch.isnan(dist)
    d = torch.where(valid, dist, torch.full_like(dist, float("inf")))
    m = d.min(dim=1).values
    hit = valid & (d == m[:, None])
    code = torch.where(hit, codes[None, :].expand_as(hit), torch.full_like(hit, INT_MAX,
                                                                             dtype=torch.int64))
    return torch.where(hit.any(1), m, torch.full_like(m, float("inf"))), code.min(dim=1).values


def _norms(cb):
    """||cb||^2 as the kernel sums it: lane p of 8 adds chunks p, p + 8, ...
    (x, y, z, w in turn), then a butterfly over the 8 lanes."""
    n_codes, d = cb.shape
    q4 = d // 4
    s = []
    for p in range(8):
        acc = torch.zeros(n_codes)
        for q in range(p, q4, 8):
            for c in range(4):
                acc = acc + cb[:, 4 * q + c] * cb[:, 4 * q + c]
        s.append(acc)
    t = [s[p] + s[p ^ 4] for p in range(8)]
    u = [t[p] + t[p ^ 2] for p in range(8)]
    return u[0] + u[1]


def emulate(x, cbs, beta=BETA, train=False, **plan_kw):
    """The kernels' order of operations for ``x`` (B, D) and ``cbs``
    (L, K, D), fp32, under the plan the launcher picks (or the cluster
    kernel's plan forced by ``rows`` and ``cluster``); rows are independent,
    so every row block of the plan is emulated at once. Returns the plain
    twin's output type."""
    x, cbs = x.float(), cbs.float()
    b, d = x.shape
    n_levels, k, _ = cbs.shape
    p = qk.plan(b, n_levels, k, d, **plan_kw)
    unit = qk.unit_codes(p["rows"])
    lanes = torch.arange(k) % 32  # the resident kernel's lane of each code
    res = x.clone()
    rr = torch.sum(res * res, dim=1)
    loss = torch.zeros(b)
    ids, pre, embs = [], [], []
    emb_sum = torch.zeros_like(res)
    for level in range(n_levels):
        # every code's distance: the arithmetic does not depend on which CTA,
        # warp or lane scores it (dot products summed over D in order)
        acc = torch.zeros(b, k)
        for dd in range(d):
            acc = acc + res[:, dd:dd + 1] * cbs[level, None, :, dd]
        dist_all = (rr[:, None] - 2.0 * acc) + _norms(cbs[level])[None, :]
        if p["resident"]:
            # one warp a row group scores every code, lane j codes j + 32 i;
            # each row's winner over the lanes
            lane_best, lane_code = [], []
            for j in range(32):
                codes = torch.nonzero(lanes == j).flatten()
                if codes.numel():
                    best, code = _lexmin(dist_all[:, codes], codes)
                    lane_best.append(best)
                    lane_code.append(code)
            _, win = _lexmin_pairs(torch.stack(lane_best, 1), torch.stack(lane_code, 1))
        else:
            win = _cluster_winner(dist_all, p, k, unit)
        win = torch.where(win >= k, torch.zeros_like(win), win)
        e = cbs[level, win]
        diff = res - e
        part = torch.sum(diff * diff, dim=1)
        loss = loss + (1.0 + beta) * part
        ids.append(win.to(torch.int32))
        pre.append(res)
        embs.append(e)
        emb_sum = emb_sum + e
        rr, res = part, diff
    ids = torch.stack(ids, dim=-1)
    if train:
        return qk.RqTrainOutput(torch.stack(embs, -1), torch.stack(pre, -1), ids, loss)
    return qk.RqTokenizeOutput(ids, emb_sum, res, loss)


def _cluster_winner(dist_all, p, k, unit):
    """The cluster kernel's winners: each CTA's slice, its units dealt to
    the warps in turn across the level's tiles, merged over the warps, then
    over the cluster's CTAs."""
    b = dist_all.shape[0]
    rank_best, rank_code = [], []
    for rank in range(p["cluster"]):
        k_lo = rank * p["slice"]
        k_n = max(0, min(p["slice"], k - k_lo))
        warp_best = torch.full((qk.WARPS, b), float("inf"))
        warp_code = torch.full((qk.WARPS, b), INT_MAX, dtype=torch.int64)
        for t in range(p["tiles"]):
            n_t = min(p["tile"], k_n - t * p["tile"])
            for u in range(0, -(-max(n_t, 0) // unit)):
                warp = (t * p["tile"] // unit + u) % qk.WARPS
                first = k_lo + t * p["tile"] + u * unit
                codes = torch.arange(first, first + min(unit, n_t - u * unit))
                cand = _lexmin(dist_all[:, codes], codes)
                both_d = torch.stack([warp_best[warp], cand[0]], dim=1)
                both_c = torch.stack([warp_code[warp], cand[1]])
                warp_best[warp], warp_code[warp] = _lexmin_pairs(both_d, both_c.T)
        best, code = _lexmin_pairs(warp_best.T, warp_code.T)
        rank_best.append(best)
        rank_code.append(code)
    return _lexmin_pairs(torch.stack(rank_best, 1), torch.stack(rank_code, 1))[1]


def _lexmin_pairs(best, code):
    """Merge (distance, code) candidates along dim 1 by the same rule."""
    m = best.min(dim=1).values
    hit = best == m[:, None]
    return m, torch.where(hit, code, torch.full_like(code, INT_MAX)).min(dim=1).values


def near_ties(x, cbs, ids, rel=1e-5):
    """Rows where, along the ``ids`` chain, the two smallest float64
    distances of a level differ by less than ``rel`` of the terms an fp32
    distance sums (||r||^2 + ||winner||^2)."""
    res = x.double()
    near = torch.zeros(x.shape[0], dtype=torch.bool)
    for level, cb in enumerate(cbs.double()):
        dist = torch.cdist(res, cb) ** 2
        two = torch.topk(dist, min(2, cb.shape[0]), dim=1, largest=False).values
        win = cb[ids[:, level].long()]
        if cb.shape[0] > 1:
            size = torch.sum(res * res, 1) + torch.sum(win * win, 1)
            near |= (two[:, 1] - two[:, 0]) < rel * size
        res = res - win
    return near


def _data(b, n_levels, k, d, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, d).astype(np.float32),
            (0.7 * rng.randn(n_levels, k, d)).astype(np.float32))


def _hold(got, want, x, cbs, names):
    gid, wid = got.sem_ids.long(), torch.from_numpy(np.array(want.sem_ids)).long()
    differ = (gid != wid).any(1)
    near = near_ties(x, cbs, wid)
    assert not bool((differ & ~near).any()), f"ids differ off near-ties: {int((differ & ~near).sum())}"
    same = ~differ
    for name in names:
        a = getattr(got, name)[same].numpy()
        w = np.asarray(getattr(want, name))[same.numpy()]
        np.testing.assert_allclose(a, w, rtol=1e-5, atol=1e-5, err_msg=name)
    return int(differ.sum())


# (B, L, K, D) and the plan each one must get: B = 1; B not a multiple of
# a CTA's rows, K not of a lane block; L = 1 at D = 4; the flagship step;
# D = 128 just under and just over the resident kernel's budget (64-code
# steps); the cluster kernel's ring at D = 128 and at a stretch-like stack,
# units dealt across tiles.
SHAPES = {
    "b1": ((1, 3, 256, 32), dict(resident=1, rows=8, stages=3, swizzled=1, grid=1)),
    "ragged": ((37, 2, 301, 16), dict(resident=1, rows=8, tile=301, swizzled=0, grid=5)),
    "l1_d4": ((70, 1, 200, 4), dict(resident=1, rows=8, stages=1, swizzled=0, grid=9)),
    "flagship": ((64, 3, 256, 32), dict(resident=1, rows=8, tile=256, stages=3, grid=8)),
    "d128_resident": ((40, 3, 128, 128), dict(resident=1, rows=8, tile=128, stages=3)),
    "d128_cluster": ((40, 3, 192, 128), dict(resident=0, rows=32, cluster=2, slice=96,
                                             tiles=1)),
    "d128_ring": ((40, 3, 520, 128), dict(resident=0, rows=16, cluster=4, slice=130, tile=128,
                                          tiles=2, stages=3)),
    "stretch_ring": ((48, 4, 2048, 64), dict(resident=0, rows=16, cluster=4, slice=512,
                                             tile=256, tiles=2, stages=3)),
}
RING = ("d128_ring", "stretch_ring")


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plan(name):
    (b, n_levels, k, d), want = SHAPES[name]
    p = qk.plan(b, n_levels, k, d)
    assert {key: p[key] for key in want} == want, p
    assert p["smem"] <= qk.H100_OPTIN
    assert p["slice"] * p["cluster"] >= k and p["tiles"] * p["tile"] >= p["slice"]
    if not p["resident"]:
        assert p["tile"] % qk.unit_codes(p["rows"]) == 0
    every_level_staged = n_levels * p["tiles"] <= p["stages"]
    assert every_level_staged == (name not in RING), p


@pytest.mark.parametrize("shape,want", [
    ((4096, 3, 256, 32), dict(resident=1, rows=32, tile=256, stages=3, grid=128)),
    ((1024, 4, 2048, 64), dict(resident=0, rows=16, cluster=2, slice=1024, tile=256, tiles=4,
                               stages=3, grid=128)),
    ((4096, 4, 2048, 64), dict(resident=0, rows=32, cluster=1, slice=2048, tile=256, tiles=8,
                               stages=3, grid=128)),
    ((513, 2, 1000, 64), dict(resident=0, rows=32, cluster=4, slice=250, grid=68)),
])
def test_plan_at_the_timed_shapes(shape, want):
    p = qk.plan(*shape)
    assert {key: p[key] for key in want} == want, p
    assert p["smem"] <= qk.H100_OPTIN


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_emulated_tokenize_matches_twin_and_pallas(name):
    (b, n_levels, k, d), _ = SHAPES[name]
    xn, cn = _data(b, n_levels, k, d, seed=len(name))
    x, cbs = torch.from_numpy(xn), torch.from_numpy(cn)
    got = emulate(x, cbs)
    names = ("emb_sum", "residual", "loss")
    _hold(got, qk.rq_tokenize_plain(x, cbs, commitment_weight=BETA), x, cbs, names)
    want = quantize_pallas.rq_tokenize(jnp.asarray(xn), jnp.asarray(cn), commitment_weight=BETA,
                                       block_b=32, interpret=True)
    _hold(got, want, x, cbs, names)


@pytest.mark.parametrize("name", ["b1", "ragged", "l1_d4", "flagship", "d128_cluster",
                                  "d128_ring"])
def test_emulated_train_forward_matches_twin_and_pallas(name):
    (b, n_levels, k, d), _ = SHAPES[name]
    xn, cn = _data(b, n_levels, k, d, seed=100 + len(name))
    x, cbs = torch.from_numpy(xn), torch.from_numpy(cn)
    got = emulate(x, cbs, train=True)
    names = ("embeddings", "residuals", "quantize_loss")
    _hold(got, qk.rq_quantize_train_plain(x, cbs, commitment_weight=BETA), x, cbs, names)
    want = quantize_pallas.rq_quantize_train(jnp.asarray(xn), jnp.asarray(cn), "STE", BETA, 32,
                                             True)
    _hold(got, want, x, cbs, names)


@pytest.mark.parametrize("rows,cluster", [(32, 1), (16, 2), (16, 4), (32, 4)])
def test_other_plans_give_the_same_answer(rows, cluster):
    """Any plan the launcher accepts is the same function (the automatic
    one here is the resident kernel's): only which CTA, warp and lane
    scores a code changes."""
    xn, cn = _data(50, 3, 300, 32, seed=7)
    x, cbs = torch.from_numpy(xn), torch.from_numpy(cn)
    auto, forced = emulate(x, cbs), emulate(x, cbs, rows=rows, cluster=cluster)
    assert torch.equal(auto.sem_ids, forced.sem_ids)
    for a, b in zip(auto[1:], forced[1:]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k,copies", [(256, (5, 130, 200)), (2048, (17, 700, 1500, 2040))])
def test_equal_codewords_in_other_slices_give_the_lowest_index(k, copies):
    """Copies of one codeword scored by several lanes (the resident kernel,
    K = 256) or in several CTAs' slices (the cluster kernel, K = 2048):
    equal distances, so the lowest index wins, in the emulation, the twin
    and the Pallas kernel."""
    rng = np.random.RandomState(k)
    cn = (0.7 * rng.randn(2, k, 32)).astype(np.float32)
    for c in copies[1:]:
        cn[0, c] = cn[0, copies[0]]
    xn = np.repeat(cn[0, copies[0]][None], 6, axis=0) + (1e-3 * rng.randn(6, 32)).astype(np.float32)
    x, cbs = torch.from_numpy(xn), torch.from_numpy(cn)
    p = qk.plan(6, 2, k, 32)
    # resident: copies in several lanes of a warp; cluster: in several CTAs
    owners = {c % 32 for c in copies} if p["resident"] else {c // p["slice"] for c in copies}
    assert len(owners) > 1, f"copies {copies} all with one owner under {p}"
    got = emulate(x, cbs)
    assert (got.sem_ids[:, 0] == copies[0]).all()
    assert (qk.rq_tokenize_plain(x, cbs).sem_ids[:, 0] == copies[0]).all()
    want = quantize_pallas.rq_tokenize(jnp.asarray(xn), jnp.asarray(cn), block_b=8,
                                       interpret=True)
    assert (np.asarray(want.sem_ids)[:, 0] == copies[0]).all()


def test_a_row_of_nan_takes_code_zero():
    xn, cn = _data(40, 2, 300, 16, seed=3)
    xn[5] = np.nan
    x, cbs = torch.from_numpy(xn), torch.from_numpy(cn)
    got = emulate(x, cbs)
    assert (got.sem_ids[5] == 0).all()
    twin = qk.rq_tokenize_plain(x, cbs)
    assert (twin.sem_ids[5] == 0).all()
    keep = torch.ones(40, dtype=torch.bool)
    keep[5] = False
    assert torch.equal(got.sem_ids[keep], twin.sem_ids[keep])


def _route_cfg(mode, embed_dim=32):
    return rqvae.RqVaeConfig(input_dim=24, embed_dim=embed_dim, hidden_dims=(32,),
                             codebook_size=256, n_layers=3, n_cat_feats=0,
                             commitment_weight=BETA, codebook_mode=mode)


@pytest.mark.parametrize("mode,embed_dim,fused", [
    ("STE", 32, True), ("ROTATION_TRICK", 32, True),
    ("GUMBEL_SOFTMAX", 32, False), ("ROTATION_TRICK", 256, False)])
def test_stage1_training_route(mode, embed_dim, fused, monkeypatch):
    """At the Amazon codebooks (3 x 256) the hard estimators take the fused
    kernel whatever the volume; Gumbel-softmax and embeddings wider than the
    kernel (the width rule) take the plain per-level loop."""
    assert rqvae.FUSED_TRAIN_MIN_CODEBOOK_VOLUME == 0
    cfg = _route_cfg(mode, embed_dim)
    params = rqvae.init(torch.Generator().manual_seed(0), cfg, device=torch.device("cpu"))
    calls = []
    real = rqvae._fused_train_quantize
    monkeypatch.setattr(rqvae, "_fused_train_quantize", lambda *a: calls.append(1) or real(*a))
    x = torch.from_numpy(np.random.RandomState(1).randn(16, 24).astype(np.float32))
    out = rqvae.forward(params, cfg, x, gumbel_t=0.2, training=True,
                        generator=torch.Generator().manual_seed(2))
    assert len(calls) == int(fused)
    assert torch.isfinite(out.loss)
