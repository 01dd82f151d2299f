"""Why the port's flat and span backward kernels keep the TPU kernels' exact
row term ``c = rowsum(dp * e) * inv`` (a sweep over every key) and do not
take the shortcut ``c = rowsum(g * out)`` from the forward's output.

The two are equal in exact arithmetic (pinned in float64 below, rows that
attend nothing included), but ``out`` is rounded to bf16, and
``ds = e * ((dp - c) * inv)`` carries c's rounding into every gradient. With
the trained model's magnitudes (|v| ~ 10, |k| ~ 3: the ML-32M step's layer-0
operands reach |dv| ~ 69) the shortcut misses the bound the card holds each
kernel to against its plain twin (``chip_smoke.py`` phases 7 and 17: bf16
2e-2, ``torch.allclose``), causal or not. That is the measured reason the
kernels spend the extra sweep. The shortcut's gradients are computed here
with the twin's arithmetic otherwise (``_bwd_with_c``, held bit for bit
against ``flash_attention._plain_bwd`` when given the exact c), on
numpy-seeded operands.
"""
import numpy as np
import pytest
import torch

from rqvae_tpu_torch.ops import flash_attention as tfa

B, H, N, DH = 2, 2, 200, 64


def _operands(dtype, seed=7, v_scale=1.0, k_scale=1.0):
    rng = np.random.RandomState(seed)
    q, k, v, g = (torch.from_numpy(rng.randn(B, H, N, DH).astype(np.float32)) for _ in range(4))
    q, k, v = q * k_scale, k * k_scale, v * v_scale
    g = g / g.pow(2).mean().sqrt()   # unit RMS, as the card's check scales it
    return [t.to(dtype) for t in (q, k, v, g)], rng


def _masker(kind, rng):
    """The mask policy's masker, with rows that attend nothing."""
    if kind == "span":
        lo = rng.randint(0, N - 60, (B, N))
        hi = lo + rng.randint(1, 60, (B, N))
        extra = rng.randint(-1, N, (B, N))
        lo[:, :7], hi[:, :7], extra[:, :7] = 0, 0, -1   # rows that attend nothing
        return tfa._span_masker(*(torch.from_numpy(a.astype(np.int32)) for a in (lo, hi, extra)))
    k_mask = torch.from_numpy(rng.rand(B, N) < 0.6)
    k_mask[0] = False                                  # batch row 0: no valid key
    return tfa._key_masker(tfa.mask_bias(k_mask, B, N, "cpu"), kind == "causal")


def _bwd_with_c(q, k, v, g, masker, c):
    """``flash_attention._plain_bwd``'s arithmetic with the row term c given."""
    scale, _, e, inv = tfa._scores(q, k, masker)
    dp = torch.matmul(g.float(), v.float().transpose(-1, -2))
    ds = (e * ((dp - c) * inv)).to(k.dtype).float()
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    g_n = (g.float() * inv).to(g.dtype).float()
    dv = torch.matmul(e.to(g.dtype).float().transpose(-1, -2), g_n)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@pytest.mark.parametrize("kind", ["key", "causal", "span"])
def test_the_shortcut_misses_the_bf16_bound_at_the_models_scale(kind):
    (q, k, v, g), rng = _operands(torch.bfloat16, v_scale=10.0, k_scale=3.0)
    masker = _masker(kind, rng)
    exact = tfa._plain_bwd(q, k, v, g, masker)
    _, _, e, inv = tfa._scores(q, k, masker)
    dp = torch.matmul(g.float(), v.float().transpose(-1, -2))
    for a, b in zip(_bwd_with_c(q, k, v, g, masker, torch.sum(dp * e, -1, keepdim=True) * inv),
                    exact):
        torch.testing.assert_close(a, b, rtol=0, atol=0)   # the copy is the twin's arithmetic
    out = tfa._plain_fwd(q, k, v, masker)[0]           # rounded to bf16, as the kernel writes it
    shortcut = _bwd_with_c(q, k, v, g, masker, torch.sum(g.float() * out.float(), -1, keepdim=True))
    assert not all(torch.allclose(a.float(), b.float(), rtol=2e-2, atol=2e-2)
                   for a, b in zip(shortcut, exact))


@pytest.mark.parametrize("kind", ["key", "causal", "span"])
def test_the_shortcut_is_c_in_exact_arithmetic(kind):
    """In float64 rowsum(g * out) equals the TPU's rowsum(dp * e) * inv, on
    every row (0 on rows that attend nothing)."""
    (q, k, v, g), rng = _operands(torch.float64, seed=8)
    s = _masker(kind, rng)(q @ k.transpose(-1, -2) / DH ** 0.5)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    inv = torch.where(m > 0.5 * tfa.NEG_INF, 1.0 / e.sum(-1, keepdim=True), 0.0)
    out = (e @ v) * inv
    tpu_c = torch.sum((g @ v.transpose(-1, -2)) * e, dim=-1, keepdim=True) * inv
    assert bool((inv == 0).any())
    np.testing.assert_allclose(torch.sum(g * out, dim=-1, keepdim=True).numpy(), tpu_c.numpy(),
                               rtol=1e-10, atol=1e-10)
