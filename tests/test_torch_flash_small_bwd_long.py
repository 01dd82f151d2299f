"""The arithmetic of the port's bf16 short backward on its strips route
(``csrc/flash_attention_small_bwd.cu``: ``small_bwd_keys_kernel`` at Nq <=
16 and ``small_bwd_strips_kernel`` above, the shapes with Nk > 96 or Nq >
208) on the CPU.

The CUDA kernels run on the GPU only (``chip_smoke.py`` holds them against
the plain twin there). Here a torch emulation of their order of operations
is held against the plain twin (``_plain_bwd``) and against JAX's
``flash_attention_small`` backward in interpret mode, at batch 2 and 2
heads:

* live key tiles only (the forward's rule: a 16-key tile with a key whose
  bias is above -5e29); a dead tile's dk and dv rows are zeros, a pair with
  no live tile gives zeros everywhere;
* Nq <= 16, the keys mode: four warps split the live tiles (warp w the
  list's entries w, w + 4, ...); each sums its tiles' e dp by row, the
  partial sums are added in warp order for c; ds = e ((dp - c) inv) rounded
  to bf16, each warp's dq partial ds k over its tiles, the partials added in
  warp order; dk, dv of each tile from that warp's ds and bf16(e);
* Nq > 16, the strips mode: strips of four live tiles; when the tiles span
  more than one strip, c from a sweep over the strips first, else from the
  one strip; then per strip each query tile's ds and dq += ds k, a (query
  tile, key tile) pair past the causal cut skipped on both sides; dk =
  ds^T q and dv = bf16(e)^T bf16(g inv) (g inv rounded once, in place of g)
  over the query tiles.

Tolerances are the kernels' own bounds on the card: bf16 2e-2 and fp32 1e-4
(absolute and relative); rows with no valid key give exact zeros. The
Python dispatcher ``small_bwd_route`` is held against a restatement of the
kernels' shared-memory budgets at every Nq, Nk <= 255.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.ops import flash_attention as jfa
from rqvae_tpu_torch.ops import flash_attention as tfa

LOG2E = 1.4426950408889634
TILE = 16
KEYS_WARPS = 4     # the keys mode's warps
STRIP_TILES = 4    # the strips mode's live tiles a strip


def _live_tiles(bias_row, nk):
    """The forward's live-tile rule on one batch row's (Nk,) key bias."""
    return [t for t in range(-(-nk // TILE))
            if bool((bias_row[TILE * t:TILE * (t + 1)] > 0.5 * tfa.NEG_INF).any())]


def _emulate(q, k, v, g, m, inv, bias, causal):
    """(dq, dk, dv) by the strips route's order of operations."""
    dt = q.dtype
    b_, h_, nq, dh = q.shape
    nk = k.shape[2]
    scale = 1.0 / math.sqrt(dh)
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    dq = torch.zeros(b_, h_, nq, dh)
    dk = torch.zeros(b_, h_, nk, dh)
    dv = torch.zeros(b_, h_, nk, dh)
    for b in range(b_):
        live = _live_tiles(bias[b], nk)
        g_inv = (gf[b] * inv[b][..., None]).to(dt).float()   # bf16(g inv), rounded once

        def tile(t, r0, r1):
            """keys of tile t, e = exp(s - m) and dp of rows r0 .. r1 - 1"""
            cols = torch.arange(TILE * t, min(TILE * (t + 1), nk))
            s = qf[b, :, r0:r1] @ kf[b, :, cols].transpose(-1, -2) * scale + bias[b, cols]
            if causal:
                s = torch.where(cols[None] > torch.arange(r0, r1)[:, None], tfa.NEG_INF, s)
            e = torch.exp2((s - m[b, :, r0:r1, None]) * LOG2E)
            return cols, e, gf[b, :, r0:r1] @ vf[b, :, cols].transpose(-1, -2)

        def rowsum(tiles, r0, r1):
            return sum(((dp * e).sum(-1) for _, e, dp in (tile(t, r0, r1) for t in tiles)),
                       torch.zeros(h_, r1 - r0))

        if nq <= TILE:   # the keys mode: one query tile, the tiles split over four warps
            warps = [live[w::KEYS_WARPS] for w in range(KEYS_WARPS)]
            c = sum((rowsum(ts, 0, nq) for ts in warps), torch.zeros(h_, nq)) * inv[b]
            partials = []
            for ts in warps:
                acc = torch.zeros(h_, nq, dh)
                for t in ts:
                    cols, e, dp = tile(t, 0, nq)
                    ds = (e * ((dp - c[..., None]) * inv[b][..., None])).to(dt).float()
                    acc = acc + ds @ kf[b, :, cols]
                    dk[b, :, cols] = ds.transpose(-1, -2) @ qf[b] * scale
                    dv[b, :, cols] = e.to(dt).float().transpose(-1, -2) @ g_inv
                partials.append(acc)
            dq[b] = sum(partials, torch.zeros(h_, nq, dh)) * scale
            continue
        # the strips mode: a warp a query tile
        strips = [live[i:i + STRIP_TILES] for i in range(0, len(live), STRIP_TILES)]
        for r0 in range(0, nq, TILE):
            r1 = min(r0 + TILE, nq)
            sees = [t for t in live if not (causal and r0 + TILE - 1 < TILE * t)]
            # c: the sweep over every strip (or the one strip), the pairs past the cut skipped
            c = rowsum(sees, r0, r1) * inv[b, :, r0:r1]
            for strip in strips:
                for t in strip:
                    if t not in sees:
                        continue
                    cols, e, dp = tile(t, r0, r1)
                    ds = (e * ((dp - c[..., None]) * inv[b, :, r0:r1, None])).to(dt).float()
                    dq[b, :, r0:r1] += ds @ kf[b, :, cols]
                    dk[b, :, cols] += ds.transpose(-1, -2) @ qf[b, :, r0:r1]
                    dv[b, :, cols] += e.to(dt).float().transpose(-1, -2) @ g_inv[:, r0:r1]
        dq[b] *= scale
        dk[b] *= scale
    return dq.to(dt), dk.to(dt), dv.to(dt)


# (name, Nq, Nk, causal, key mask): the ML-32M short bucket and its cross
# attention, a decode-step row, two query tiles, a causal full-width shape,
# a tall shape at 96 keys (Nq > 208), a batch row with no valid key, and
# dead middle tiles (keys 16-47 masked)
CASES = [("bucket_241", 241, 241, False, "ragged"), ("cross_5x241", 5, 241, False, "ragged"),
         ("row_1x241", 1, 241, False, "ragged"), ("two_tiles_17x241", 17, 241, False, "ragged"),
         ("causal_255", 255, 255, True, "ragged"), ("tall_209x96", 209, 96, False, "ragged"),
         ("no_valid_key_241", 241, 241, False, "empty_row"),
         ("dead_middle_241", 241, 241, False, "dead_middle")]
DTYPES = [(torch.bfloat16, jnp.bfloat16, 2e-2), (torch.float32, jnp.float32, 1e-4)]


def _operands(name, nq, nk, mask, dtype):
    rng = np.random.RandomState(sum(map(ord, name)))
    q, g = (rng.randn(2, 2, nq, 64).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(2, 2, nk, 64).astype(np.float32) for _ in range(2))
    cols = np.arange(nk)[None, :]
    if mask == "dead_middle":
        km = (rng.rand(2, nk) < 0.5) & ((cols < 16) | (cols >= 48))
    else:
        km = cols < rng.randint(1, nk + 1, (2,))[:, None]
        if mask == "empty_row":
            km[0] = False
    # round through the operand type once, so both packages read the same values
    t = [torch.from_numpy(a).to(dtype) for a in (q, k, v, g)]
    return t, torch.from_numpy(km)


def _stats(q, k, v, km, causal):
    bias = tfa.mask_bias(km, 2, k.shape[2], q.device)
    _, m, inv = tfa._plain_fwd(q, k, v, tfa._key_masker(bias, causal))
    return bias, m, inv


def test_cases_take_the_strips_route_and_skip_tiles():
    assert all(tfa.small_bwd_route(nq, nk) == "strips" for _, nq, nk, _, _ in CASES)
    (q, k, v, _), km = _operands("dead_middle_241", 241, 241, "dead_middle", torch.float32)
    bias = tfa.mask_bias(km, 2, 241, q.device)
    for b in range(2):   # tiles 1 and 2 hold only masked keys
        live = _live_tiles(bias[b], 241)
        assert 1 not in live and 2 not in live and 0 in live and len(live) >= 10
    (q, k, v, _), km = _operands("no_valid_key_241", 241, 241, "empty_row", torch.float32)
    assert _live_tiles(tfa.mask_bias(km, 2, 241, q.device)[0], 241) == []


@pytest.mark.parametrize("dtype,jdtype,tol", DTYPES, ids=["bf16", "fp32"])
@pytest.mark.parametrize("name,nq,nk,causal,mask", CASES, ids=[c[0] for c in CASES])
def test_strips_arithmetic_matches_the_twin(name, nq, nk, causal, mask, dtype, jdtype, tol):
    (q, k, v, g), km = _operands(name, nq, nk, mask, dtype)
    bias, m, inv = _stats(q, k, v, km, causal)
    got = _emulate(q, k, v, g, m, inv, bias, causal)
    want = tfa._plain_bwd(q, k, v, g, tfa._key_masker(bias, causal))
    for label, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), rtol=tol, atol=tol,
                                   err_msg=f"{name} {label}")
    if mask == "empty_row":   # a batch row with no valid key: exact zeros
        for a in got:
            assert float(a[0].abs().max()) == 0.0
    if mask == "dead_middle":   # keys in dead tiles: dk = dv = 0 exactly
        for a in got[1:]:
            assert float(a[:, :, 16:48].abs().max()) == 0.0


@pytest.mark.parametrize("dtype,jdtype,tol", DTYPES, ids=["bf16", "fp32"])
@pytest.mark.parametrize("name,nq,nk,causal,mask", CASES, ids=[c[0] for c in CASES])
def test_strips_arithmetic_matches_jax_backward(name, nq, nk, causal, mask, dtype, jdtype, tol):
    (q, k, v, g), km = _operands(name, nq, nk, mask, dtype)
    bias, m, inv = _stats(q, k, v, km, causal)
    got = _emulate(q, k, v, g, m, inv, bias, causal)
    jq, jk, jv, jg = (jnp.asarray(t.float().numpy(), jdtype) for t in (q, k, v, g))
    _, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention_small(
        a, b, c, k_mask=jnp.asarray(km.numpy()), causal=causal, interpret=True), jq, jk, jv)
    for label, a, b in zip(("dq", "dk", "dv"), got, vjp(jg)):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b.astype(jnp.float32)),
                                   rtol=tol, atol=tol, err_msg=f"{name} {label}")


def test_route_against_the_shared_memory_budgets():
    """``small_bwd_route`` and ``small_bwd_strips_smem`` against the
    kernels' budgets restated: the tiles kernel while its two query sides,
    key side and e / ds fit one CTA (232,448 bytes) and the keys fit its
    96-key row; the rows kernel at one query tile; else the strips route,
    whose keys mode (Nq <= 16) fits three CTAs an SM (233,472 bytes, 1,024
    reserved a CTA) and whose strips mode fits one CTA."""
    one_cta, sm, reserve = 232448, 233472, 1024
    for nq in range(1, 256):
        nqp = 16 * -(-nq // 16)
        for nk in range(1, 256):
            nkp = 16 * -(-nk // 16)
            tiles = 2 * nqp * (2 * 64 * 2 + 8) + nkp * (2 * 64 * 2 + 4) + 2 * nqp * (nkp + 8) * 2
            want = ("strips" if nkp > 96 else "rows" if nqp == 16 else
                    "tiles" if tiles <= one_cta else "strips")
            assert tfa.small_bwd_route(nq, nk) == want, (nq, nk)
            if want != "strips":
                continue
            if nqp == 16:
                smem = (2 * 16 + 2 * 16 * 16) * 64 * 2 + (2 + KEYS_WARPS + 16) * 16 * 4
                assert 3 * (smem + reserve) <= sm
            else:
                smem = (nqp * (2 * 64 * 2 + 8) + 4 * nkp + 3 * 2 * STRIP_TILES * 16 * 64 * 2
                        + 2 * nqp * (16 * STRIP_TILES + 8) * 2)
                assert smem <= one_cta
            assert tfa.small_bwd_strips_smem(nq, nk) == smem, (nq, nk)
