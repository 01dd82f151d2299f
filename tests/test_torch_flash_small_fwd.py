"""The arithmetic of the port's bf16 short-sequence forward kernel
(``csrc/flash_attention_small_fwd.cu``: ``small_fwd_live_kernel``) on the
CPU.

The CUDA kernel runs on the GPU only (``chip_smoke.py`` holds it against the
plain twin there). Here a torch emulation of its order of operations is
held against the plain twin (``_plain_fwd``) and against JAX's
``flash_attention_small`` in interpret mode, and its m and inv are fed to
the backward kernels' emulation (``tests/test_torch_flash_small_bwd.py``):

* the live-tile rule: a 16-key tile is live when one of its keys has a
  bias above -5e29; only live tiles' K and V rows are staged, packed in
  tile order (rows past Nk zero), and under the causal cut a query tile
  computes only the live tiles at or below its last row;
* scores in log2 units, dot (scale log2 e) + bias log2 e (-inf past Nk),
  the causal cut -1e30 log2 e; one max and one sum over the whole row of
  computed tiles; e = 2^(s - m), rounded to bf16 before the PV product;
* the stored statistics: m = m2 ln 2 and inv = 1 / sum, or m = -1e30,
  inv = 0 (and a zero output row) where the row met no valid key.

Cases are small-batch versions of the Amazon step's and serving's shapes:
81 x 81 under a ragged right-padded mask, with holes (a middle tile dead),
with a batch row that has no valid key, and with every key valid; 5 x 81;
5 x 5 causal; the beam-folded 32 x 81; and a causal 48 x 40 whose query
tiles skip different live tiles. Tolerances are the kernel's own bounds on
the card: bf16 2e-2 and fp32 1e-4 (absolute and relative); rows with no
valid key give m = -1e30, inv = 0 and zeros exactly.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.ops import flash_attention as jfa
from rqvae_tpu_torch.ops import flash_attention as tfa
from test_torch_flash_small_bwd import _emulate as _emulate_bwd

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
TILE = 16


def _live_tiles(bias_row, nk):
    """The kernel's live-tile rule for one batch row's (Nk,) key bias."""
    return [t for t in range(-(-nk // TILE))
            if bool((bias_row[TILE * t:TILE * (t + 1)] > 0.5 * tfa.NEG_INF).any())]


def _emulate(q, k, v, bias, causal):
    """(out, m, inv) by the live-tile kernel's order of operations."""
    dt = q.dtype
    b, h, nq, _ = q.shape
    nk = k.shape[2]
    scale2 = torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=torch.float32) * LOG2E
    neg2 = torch.tensor(tfa.NEG_INF, dtype=torch.float32) * LOG2E
    out = torch.zeros(q.shape, dtype=torch.float32)
    m = torch.empty((b, h, nq))
    inv = torch.empty((b, h, nq))
    rows = torch.arange(nq)[:, None]
    for i in range(b):
        live = _live_tiles(bias[i], nk)
        # the staged, packed key rows: live tile j holds keys 16 t .. 16 t + 15
        keys = torch.tensor([TILE * t + r for t in live for r in range(TILE)], dtype=torch.long)
        inside = keys < nk
        kp = torch.zeros((h, len(keys), k.shape[-1]))
        vp = torch.zeros_like(kp)
        kp[:, inside] = k[i][:, keys[inside]].float()
        vp[:, inside] = v[i][:, keys[inside]].float()
        b2 = torch.full((len(keys),), -math.inf)
        b2[inside] = bias[i][keys[inside]] * LOG2E   # the bias in log2 units, -inf past Nk
        s = q[i].float() @ kp.transpose(-1, -2) * scale2 + b2
        cols = keys[None, :]
        if causal:
            s = torch.where(cols > rows, neg2, s)
            # a query tile computes the live tiles at or below its last row
            s = torch.where(cols // TILE > rows // TILE, -math.inf, s)
        mx = torch.amax(s, dim=-1, keepdim=True) if len(keys) else torch.full((h, nq, 1), -math.inf)
        met = mx > 0.5 * neg2            # the row met a valid key
        e = torch.exp2(s - torch.where(met, mx, 0.0))
        e = torch.where(met, e, 0.0)     # (a dead row's e never reaches its output: inv = 0)
        rs = torch.sum(e, dim=-1, keepdim=True)
        inv_i = torch.where(met, 1.0 / rs, 0.0)
        out[i] = (e.to(dt).float() @ vp) * inv_i
        m[i] = torch.where(met, mx * LN2, tfa.NEG_INF)[..., 0]
        inv[i] = inv_i[..., 0]
    return out.to(dt), m, inv


# (name, Nq, Nk, causal, key mask)
CASES = [("encoder_ragged", 81, 81, False, "ragged"), ("encoder_holes", 81, 81, False, "holes"),
         ("encoder_dead_row", 81, 81, False, "dead_row"),
         ("encoder_all_valid", 81, 81, False, None), ("cross", 5, 81, False, "ragged"),
         ("decoder_self", 5, 5, True, None), ("beam_cross_32x81", 32, 81, False, "ragged"),
         ("causal_48x40", 48, 40, True, "dead_row")]
DTYPES = [(torch.bfloat16, jnp.bfloat16, 2e-2), (torch.float32, jnp.float32, 1e-4)]


def _operands(name, nq, nk, mask, dtype):
    rng = np.random.RandomState(sum(map(ord, name)))
    q, g = (rng.randn(2, 2, nq, 64).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(2, 2, nk, 64).astype(np.float32) for _ in range(2))
    km = None
    if mask is not None:   # right-padded past the middle of the row
        km = np.arange(nk)[None, :] < rng.randint(min(nk, nk // 2 + 9), nk + 1, (2,))[:, None]
        if mask == "holes":   # keys 32-47 (tile 2) and a scatter of others masked
            km[:, 32:48] = False
            km &= rng.rand(2, nk) < 0.8
            km[:, 0] = True
        if mask == "dead_row":
            km[0] = False
    t = [torch.from_numpy(a).to(dtype) for a in (q, k, v, g)]
    return t, (None if km is None else torch.from_numpy(km))


def test_live_tile_rule():
    (q, k, v, _), km = _operands("encoder_holes", 81, 81, "holes", torch.float32)
    bias = tfa.mask_bias(km, 2, 81, q.device)
    for i in range(2):
        live = _live_tiles(bias[i], 81)
        want = [t for t in range(6) if bool(km[i, 16 * t:16 * t + 16].any())]
        assert live == want and 2 not in live and 0 in live
    no_key = tfa.mask_bias(torch.zeros((1, 81), dtype=torch.bool), 1, 81, "cpu")
    assert _live_tiles(no_key[0], 81) == []
    assert _live_tiles(torch.zeros(5), 5) == [0]


@pytest.mark.parametrize("dtype,jdtype,tol", DTYPES, ids=["bf16", "fp32"])
@pytest.mark.parametrize("name,nq,nk,causal,mask", CASES, ids=[c[0] for c in CASES])
def test_kernel_arithmetic_matches_the_twin(name, nq, nk, causal, mask, dtype, jdtype, tol):
    (q, k, v, _), km = _operands(name, nq, nk, mask, dtype)
    bias = tfa.mask_bias(km, 2, nk, q.device)
    out, m, inv = _emulate(q, k, v, bias, causal)
    ref, ref_m, ref_inv = tfa._plain_fwd(q, k, v, tfa._key_masker(bias, causal))
    np.testing.assert_allclose(out.float().numpy(), ref.float().numpy(), rtol=tol, atol=tol,
                               err_msg=name)
    dead = ref_m <= 0.5 * tfa.NEG_INF
    assert bool((m[dead] == tfa.NEG_INF).all()) and bool((inv[dead] == 0).all())
    assert bool((out.float()[dead] == 0).all())
    live = ~dead
    assert float((m - ref_m)[live].abs().max()) <= 1e-5 * float(ref_m[live].abs().max())
    inv_tol = 1e-3 if dtype == torch.bfloat16 else 1e-5
    assert float(((inv - ref_inv) / ref_inv)[live].abs().max()) <= inv_tol
    if mask == "dead_row":   # a batch row with no valid key
        assert bool(dead[0].all()) and float(out[0].float().abs().max()) == 0.0


@pytest.mark.parametrize("dtype,jdtype,tol", DTYPES, ids=["bf16", "fp32"])
@pytest.mark.parametrize("name,nq,nk,causal,mask", CASES, ids=[c[0] for c in CASES])
def test_kernel_arithmetic_matches_jax_kernel(name, nq, nk, causal, mask, dtype, jdtype, tol):
    (q, k, v, _), km = _operands(name, nq, nk, mask, dtype)
    out, _, _ = _emulate(q, k, v, tfa.mask_bias(km, 2, nk, q.device), causal)
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jdtype) for t in (q, k, v))
    jkm = None if km is None else jnp.asarray(km.numpy())
    want = jfa.flash_attention_small(jq, jk, jv, k_mask=jkm, causal=causal, interpret=True)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want.astype(jnp.float32)), rtol=tol,
                               atol=tol, err_msg=name)


@pytest.mark.parametrize("dtype,jdtype,tol", DTYPES, ids=["bf16", "fp32"])
@pytest.mark.parametrize("name,nq,nk,causal,mask", CASES, ids=[c[0] for c in CASES])
def test_backward_fed_the_new_statistics(name, nq, nk, causal, mask, dtype, jdtype, tol):
    """The backward kernels' emulation, fed this forward's m (natural units,
    from log2 units) and inv, against the plain backward."""
    (q, k, v, g), km = _operands(name, nq, nk, mask, dtype)
    bias = tfa.mask_bias(km, 2, nk, q.device)
    _, m, inv = _emulate(q, k, v, bias, causal)
    got = _emulate_bwd(q, k, v, g, m, inv, bias, causal)
    want = tfa._plain_bwd(q, k, v, g, tfa._key_masker(bias, causal))
    for label, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), rtol=tol, atol=tol,
                                   err_msg=f"{name} {label}")
    if mask == "dead_row":
        for a in got:
            assert float(a[0].abs().max()) == 0.0
