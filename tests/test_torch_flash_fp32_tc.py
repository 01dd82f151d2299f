"""The fp32 flat and span flash kernels' arithmetic on the tensor cores
(``csrc/flash_attention_fwd.cuh``: ``flash_fwd_tf32_kernel``;
``csrc/flash_attention_bwd.cuh``: ``flash_bwd_c_tf32_kernel``,
``flash_bwd_tf32_kernel``), emulated in torch on the CPU, against the twins
and the JAX package's Pallas kernels in interpret mode.

The emulation follows the kernels' order of operations: every product as
three TF32 products (TF32 rounding by bit arithmetic, round to nearest and
ties away on the 13 dropped bits as ``cvt.rna.tf32.f32``; each operand
split into big = tf32(x) and small = tf32(x - big); small x big + big x
small + big x big, fp32 accumulation); the forward over 64-key tiles, each
64-row block computing only the tiles its rows attend, the online softmax
in log2 units, m stored as m2 ln 2 (-1e30 for a row that met no allowed
key) and inv = 0 exactly there; the backward's exact c = rowsum(dp * e)
inv over the pairs with something to attend, ds = e ((dp - c) inv),
dq = ds k scale, dk = ds^T q scale, dv = e^T (g inv). Inputs are
numpy-seeded fp32; the bound is the kernels' own against their twins,
1e-4 (``torch.allclose`` rtol = atol), and rows that attend nothing are
exactly 0. A last case pins why three products: one TF32 product misses
1e-4 of max-abs at the model's magnitudes.
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
NEG2 = -1e30 * LOG2E
TOL = 1e-4


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 (kept as fp32): round to nearest, ties away from zero,
    on the 13 dropped mantissa bits (the sign-magnitude bits carry)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as three TF32 products with fp32 accumulation."""
    ab, bb = tf32(a), tf32(b)
    return tf32(a - ab) @ bb + ab @ tf32(b - bb) + ab @ bb


def mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as one TF32 product."""
    return tf32(a) @ tf32(b)


def _live(allow: torch.Tensor, nq: int, nk: int) -> torch.Tensor:
    """(B, H', Nq, Nk) bool: the (64-row block, 64-key tile) pairs the
    kernels compute (a pair in which some row of the block may attend some
    key of the tile), spread over their rows and keys."""
    pad_q, pad_k = -nq % 64, -nk % 64
    a = torch.nn.functional.pad(allow, (0, pad_k, 0, pad_q))
    b, h = a.shape[:2]
    blocks = a.reshape(b, h, a.shape[2] // 64, 64, a.shape[3] // 64, 64).any(5).any(3)
    return blocks.repeat_interleave(64, 2).repeat_interleave(64, 3)[:, :, :nq, :nk]


def emu_fwd(q, k, v, allow, prod=mm3):
    """(out, m, inv) of the tensor-core forward; ``allow`` (B, 1 or H, Nq,
    Nk) bool."""
    b, h, nq, dh = q.shape
    nk = k.shape[2]
    sl2 = LOG2E / math.sqrt(dh)
    live = _live(allow, nq, nk).expand(b, h, nq, nk)
    m2 = torch.full((b, h, nq), -math.inf)
    l = torch.zeros((b, h, nq))
    acc = torch.zeros((b, h, nq, dh))
    for k0 in range(0, nk, 64):
        kt = slice(k0, min(k0 + 64, nk))
        s2 = torch.where(allow[..., kt], prod(q, k[:, :, kt].transpose(-1, -2)) * sl2, NEG2)
        mn = torch.maximum(m2, s2.amax(-1))
        alpha = torch.exp2(m2 - mn)
        e = torch.exp2(s2 - mn[..., None])
        on = live[..., kt].any(-1)   # this row's block computes the tile
        acc = torch.where(on[..., None], acc * alpha[..., None] + prod(e, v[:, :, kt]), acc)
        l = torch.where(on, l * alpha + e.sum(-1), l)
        m2 = torch.where(on, mn, m2)
    hit = m2 > 0.5 * NEG2
    inv = torch.where(hit, 1.0 / l, torch.zeros(()))
    return acc * inv[..., None], torch.where(hit, m2 / LOG2E, torch.full((), -1e30)), inv


def emu_bwd(q, k, v, g, m, inv, allow, prod=mm3):
    """(dq, dk, dv) of the tensor-core backward, from the forward's m, inv."""
    nq, dh = q.shape[2], q.shape[3]
    nk = k.shape[2]
    scale = 1.0 / math.sqrt(dh)
    live = _live(allow, nq, nk)
    s = torch.where(allow, prod(q, k.transpose(-1, -2)) * scale, -1e30)
    e = torch.where(live, torch.exp(s - m[..., None]), 0.0)
    dp = prod(g, v.transpose(-1, -2))
    c = (dp * e).sum(-1, keepdim=True) * inv[..., None]
    ds = e * ((dp - c) * inv[..., None])
    dq = prod(ds, k) * scale
    dk = prod(ds.transpose(-1, -2), q) * scale
    dv = prod(e.transpose(-1, -2), g * inv[..., None])
    return dq, dk, dv


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _flat_case(seed, b, h, n, causal, mag=(1.0, 1.0, 1.0)):
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(b, h, n, 64).astype(np.float32) * s for s in mag + (1.0,))
    km = rng.rand(b, n) < 0.6
    if b > 1:
        km[0] = False            # a batch row with no valid key
        km[1, :70] = False       # a whole masked key tile, valid keys after
    allow = torch.from_numpy(km)[:, None, None, :].expand(b, 1, n, n)
    if causal:
        allow = allow & torch.ones((n, n), dtype=torch.bool).tril()
    return _t(q, k, v, g, km), allow


def _span_case(seed, b, h, n):
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(b, h, n, 64).astype(np.float32) for _ in range(4))
    lo = np.zeros((b, n), np.int32)
    hi = np.zeros((b, n), np.int32)
    ex = np.full((b, n), -1, np.int32)
    for r in range(b):
        pos, slot = 4, 0
        while pos < n - 8 and slot < 4:   # segments of a packed row, user tokens 0..3
            length = int(rng.randint(8, 60))
            end = min(pos + length, n - 8)   # the last 8 rows attend nothing
            rows = np.arange(pos, end)
            lo[r, rows], hi[r, rows], ex[r, rows] = pos, rows + 1, slot   # causal in the segment
            pos, slot = end, slot + 1
    spans = _t(lo, hi, ex)
    allow = tfa.span_mask(tuple(spans), n)[:, None]
    return _t(q, k, v, g) + spans, allow


def _close(got, want, what):
    for name, x, y in zip(("out", "dq", "dk", "dv"), got, want):
        x, y = torch.as_tensor(np.array(x)), torch.as_tensor(np.array(y))
        err = float((x - y).abs().max())
        assert torch.allclose(x, y, rtol=TOL, atol=TOL), f"{what} {name}: max |err| {err}"


@pytest.mark.parametrize("causal", [False, True])
def test_flat_emulation_matches_twins_and_jax(causal):
    (q, k, v, g, km), allow = _flat_case(0, 3, 2, 150, causal)
    out, m, inv = emu_fwd(q, k, v, allow)
    grads = emu_bwd(q, k, v, g, m, inv, allow)
    want = (tfa.flash_attention_plain(q, k, v, k_mask=km, causal=causal),) + \
        tfa.flash_attention_bwd_plain(q, k, v, g, k_mask=km, causal=causal)
    _close((out,) + grads, want, "twin")
    _, ref_m, ref_inv = tfa.flash_attention_fwd(q, k, v, k_mask=km, causal=causal)
    assert torch.equal(inv == 0, ref_inv == 0) and torch.equal(m <= -5e29, ref_m <= -5e29)

    jq, jk, jv, jg = (jnp.asarray(t.numpy()) for t in (q, k, v, g))
    jout, vjp = jax.vjp(lambda a, b_, c: jfa.flash_attention(
        a, b_, c, k_mask=jnp.asarray(km.numpy()), causal=causal, block_q=64, interpret=True),
        jq, jk, jv)
    _close((out,) + grads, (jout,) + vjp(jg), "jax")
    # batch row 0 attends nothing: zeros, values and gradients, exactly
    assert float(out[0].abs().max()) == 0.0 and float(inv[0].abs().max()) == 0.0
    assert max(float(t[0].abs().max()) for t in grads) == 0.0


def test_span_emulation_matches_twins_and_jax():
    (q, k, v, g, lo, hi, ex), allow = _span_case(1, 2, 2, 136)
    out, m, inv = emu_fwd(q, k, v, allow)
    grads = emu_bwd(q, k, v, g, m, inv, allow)
    want = (tfa.flash_attention_spans_plain(q, k, v, lo, hi, ex),) + \
        tfa.flash_attention_spans_bwd_plain(q, k, v, lo, hi, ex, g)
    _close((out,) + grads, want, "twin")
    jq, jk, jv, jg = (jnp.asarray(t.numpy()) for t in (q, k, v, g))
    js = [jnp.asarray(t.numpy()) for t in (lo, hi, ex)]
    jout, vjp = jax.vjp(lambda a, b_, c: jfa.flash_attention_spans(a, b_, c, *js, interpret=True),
                        jq, jk, jv)
    _close((out,) + grads, (jout,) + vjp(jg), "jax")
    dead = ex == -1   # rows with no span (lo = hi = 0, extra -1)
    assert bool(dead.any())
    assert float(out[:, :, :][dead[:, None].expand_as(out[..., 0])].abs().max()) == 0.0
    assert float(grads[0][dead[:, None].expand_as(out[..., 0])].abs().max()) == 0.0


def test_three_products_are_needed():
    """At the model's magnitudes (q, k x3, v x10; one 801 x 64 head) one TF32
    product misses 1e-4 of max-abs in the output and gradients (~2.4e-3);
    three stay an order of magnitude below it (~5e-6)."""
    (q, k, v, g, km), _ = _flat_case(2, 1, 1, 801, False, mag=(3.0, 3.0, 10.0))
    km = torch.ones_like(km)
    allow = torch.ones((1, 1, 801, 801), dtype=torch.bool)
    want = (tfa.flash_attention_plain(q, k, v, k_mask=km),) + tfa.flash_attention_bwd_plain(
        q, k, v, g, k_mask=km)
    shares = {}
    for name, prod in (("1xTF32", mm1), ("3xTF32", mm3)):
        out, m, inv = emu_fwd(q, k, v, allow, prod)
        got = (out,) + emu_bwd(q, k, v, g, m, inv, allow, prod)
        shares[name] = max(float((x - y).abs().max()) / float(y.abs().max())
                           for x, y in zip(got, want))
    assert shares["1xTF32"] > TOL, shares
    assert shares["3xTF32"] < TOL / 10, shares
