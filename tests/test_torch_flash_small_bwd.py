"""The arithmetic of the port's bf16 short-sequence backward kernels
(``csrc/flash_attention_small_bwd.cu``: ``small_bwd_tiles_kernel`` and
``small_bwd_rows_kernel``) on the CPU, and the key bias the autograd
function hands from the forward to the backward.

The CUDA kernels run on the GPU only (``chip_smoke.py`` holds them against
the plain twin there). Here a torch emulation of their order of operations
is held against the plain twin (``_plain_bwd``) and against JAX's
``flash_attention_small`` backward in interpret mode, at small-batch
versions of the three Amazon step shapes (encoder self 81 x 81 under a
ragged key mask, decoder self 5 x 5 causal, cross 5 x 81) and an 81 x 81
case whose first batch row has no valid key:

* the query pass: s = q k^T and dp = g v^T over every key, e = exp(s - m)
  against the forward's row max (as exp2 of (s - m) log2 e, the kernel's
  ``__expf``), c = rowsum(dp e) inv from the whole row, ds = e ((dp - c)
  inv) rounded to the operand type, dq = ds k;
* the key side reads that pass's bf16 e and ds (staged in shared memory by
  the tiles kernel, more than 16 queries; kept in registers and transposed
  there by the rows kernel, at most 16): dk = ds^T q, dv = bf16(e)^T
  bf16(g inv), g inv formed as the product reads it (no staged copy), query
  tiles wholly above a key tile skipped under the causal cut, fp32 sums,
  outputs rounded to the operand type.

Tolerances are the kernels' own bounds on the card: bf16 2e-2 and fp32
1e-4 (absolute and relative); rows with no valid key give exact zeros.
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


def _emulate(q, k, v, g, m, inv, bias, causal):
    """(dq, dk, dv) by the tiles / rows kernels' order of operations."""
    dt = q.dtype
    nq, nk = q.shape[2], k.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    rows = torch.arange(nq)[:, None]
    cols = torch.arange(nk)[None, :]
    m_, inv_ = m[..., None], inv[..., None]

    def e_of(dot):   # dot: raw q k^T products laid out (B, H, Nq, Nk)
        s = dot * scale + bias[:, None, None, :]
        if causal:
            s = torch.where(cols > rows, tfa.NEG_INF, s)
        return torch.exp2((s - m_) * LOG2E)

    # query pass: a warp owns 16 rows and sees their whole score row
    e = e_of(qf @ kf.transpose(-1, -2))
    dp = gf @ vf.transpose(-1, -2)
    c = torch.sum(dp * e, dim=-1, keepdim=True) * inv_
    ds = (e * ((dp - c) * inv_)).to(dt).float()
    dq = (ds @ kf) * scale

    # key side: the bf16 e and ds of the query pass; a query tile wholly
    # above a key tile is skipped under the causal cut (exact: there e = 0,
    # or a row with no valid key, whose ds and g inv are 0)
    e_k, ds_k = e.to(dt).float(), ds
    if causal and tfa.small_bwd_route(nq, nk) == "tiles":
        skip = TILE * (rows // TILE) + TILE - 1 < TILE * (cols // TILE)
        e_k = torch.where(skip, 0.0, e_k)
        ds_k = torch.where(skip, 0.0, ds_k)
    g_inv = (gf * inv_).to(dt).float()
    dk = (ds_k.transpose(-1, -2) @ qf) * scale
    dv = e_k.transpose(-1, -2) @ g_inv
    return dq.to(dt), dk.to(dt), dv.to(dt)


# (name, Nq, Nk, causal, key mask): the Amazon step's three shapes at batch
# 2, rows with no valid key, and a causal shape on the tiles kernel (its
# key pass skips query tiles above a key tile)
CASES = [("encoder_self", 81, 81, False, "ragged"), ("decoder_self", 5, 5, True, None),
         ("cross", 5, 81, False, "ragged"), ("encoder_no_valid_key", 81, 81, False, "empty_row"),
         ("causal_tiles", 48, 40, True, "empty_row")]
DTYPES = [(torch.bfloat16, jnp.bfloat16, 2e-2), (torch.float32, jnp.float32, 1e-4)]


def _operands(name, nq, nk, mask, dtype):
    rng = np.random.RandomState(sum(map(ord, name)))
    q, g = (rng.randn(2, 2, nq, 64).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(2, 2, nk, 64).astype(np.float32) for _ in range(2))
    km = None
    if mask is not None:
        km = np.arange(nk)[None, :] < rng.randint(nk // 2, nk + 1, (2,))[:, None]
        if mask == "empty_row":
            km[0] = False
    # round through the operand type once, so both packages read the same values
    t = [torch.from_numpy(a).to(dtype) for a in (q, k, v, g)]
    return t, (None if km is None else torch.from_numpy(km))


def test_route_of_the_amazon_shapes():
    route = tfa.small_bwd_route
    assert [route(nq, nk) for _, nq, nk, _, _ in CASES] == ["tiles", "rows", "rows", "tiles",
                                                            "tiles"]
    assert route(32, 81) == "tiles" and route(1, 4) == "rows"
    assert route(241, 241) == "strips" and route(5, 241) == "strips"
    assert route(208, 96) == "tiles" and route(209, 96) == "strips" and route(255, 16) == "tiles"


@pytest.mark.parametrize("dtype,jdtype,tol", DTYPES, ids=["bf16", "fp32"])
@pytest.mark.parametrize("name,nq,nk,causal,mask", CASES, ids=[c[0] for c in CASES])
def test_kernel_arithmetic_matches_the_twin(name, nq, nk, causal, mask, dtype, jdtype, tol):
    (q, k, v, g), km = _operands(name, nq, nk, mask, dtype)
    bias = tfa.mask_bias(km, 2, nk, q.device)
    masker = tfa._key_masker(bias, causal)
    _, m, inv = tfa._plain_fwd(q, k, v, masker)
    got = _emulate(q, k, v, g, m, inv, bias, causal)
    want = tfa._plain_bwd(q, k, v, g, masker)
    for label, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), rtol=tol, atol=tol,
                                   err_msg=f"{name} {label}")
    if mask == "empty_row":   # a batch row with no valid key: exact zeros
        for a in got:
            assert float(a[0].abs().max()) == 0.0


@pytest.mark.parametrize("dtype,jdtype,tol", DTYPES, ids=["bf16", "fp32"])
@pytest.mark.parametrize("name,nq,nk,causal,mask", CASES, ids=[c[0] for c in CASES])
def test_kernel_arithmetic_matches_jax_backward(name, nq, nk, causal, mask, dtype, jdtype, tol):
    (q, k, v, g), km = _operands(name, nq, nk, mask, dtype)
    bias = tfa.mask_bias(km, 2, nk, q.device)
    _, m, inv = tfa._plain_fwd(q, k, v, tfa._key_masker(bias, causal))
    got = _emulate(q, k, v, g, m, inv, bias, causal)
    jq, jk, jv, jg = (jnp.asarray(t.float().numpy(), jdtype) for t in (q, k, v, g))
    jkm = None if km is None else jnp.asarray(km.numpy())
    _, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention_small(
        a, b, c, k_mask=jkm, causal=causal, interpret=True), jq, jk, jv)
    for label, a, b in zip(("dq", "dk", "dv"), got, vjp(jg)):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b.astype(jnp.float32)),
                                   rtol=tol, atol=tol, err_msg=f"{name} {label}")


@pytest.mark.parametrize("small", [True, False], ids=["short", "flat"])
def test_backward_reads_the_bias_the_forward_built(small, monkeypatch):
    """The autograd function builds the (B, Nk) key bias once, in the
    forward, and its backward reads that tensor: equal to the bias the
    backward wrappers would rebuild from the key mask, and no second
    ``mask_bias`` call."""
    (q, k, v, g), km = _operands("encoder_no_valid_key", 9, 11, "empty_row", torch.float32)
    calls, seen = [], []
    real_bias, real_bwd = tfa.mask_bias, tfa._bias_bwd

    def counting_bias(*args):
        calls.append(args)
        return real_bias(*args)

    def recording_bwd(wrapper, q_, k_, v_, g_, m_, inv_, bias, causal):
        seen.append(bias)
        return real_bwd(wrapper, q_, k_, v_, g_, m_, inv_, bias, causal)

    monkeypatch.setattr(tfa, "mask_bias", counting_bias)
    monkeypatch.setattr(tfa, "_bias_bwd", recording_bwd)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    attend = tfa.flash_attention_small if small else tfa.flash_attention
    out = attend(*leaves, k_mask=km, causal=True)
    saved = out.grad_fn.saved_tensors[3]
    got = torch.autograd.grad(out, leaves, g)
    assert len(calls) == 1 and len(seen) == 1 and seen[0] is not None
    rebuilt = real_bias(km, 2, 11, q.device)
    assert torch.equal(saved, rebuilt) and torch.equal(seen[0], rebuilt)
    want = tfa.flash_attention_bwd_plain(q, k, v, g, k_mask=km, causal=True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
