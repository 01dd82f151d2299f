"""The port's flash attention (``rqvae_tpu_torch.ops.flash_attention``) and
the flash route of its ``attend`` against the JAX package.

On the CPU the wrappers run their plain PyTorch twins (the CUDA kernels
build and run on the GPU only; ``chip_smoke.py`` holds them against these
twins there). The JAX flash kernel runs in interpret mode, as
tests/test_flash_attention.py runs it. Inputs are numpy-seeded and fp32.
Tolerances are the JAX tests' own: 2e-5 on values, 1e-4 on gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.ops import attention as jattn
from rqvae_tpu.ops import flash_attention as jfa
from rqvae_tpu_torch.ops import attention as tattn
from rqvae_tpu_torch.ops import flash_attention as tfa


def _qkv(seed, b, h, nq, nk, dh):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, nq, dh).astype(np.float32), rng.randn(b, h, nk, dh).astype(np.float32),
            rng.randn(b, h, nk, dh).astype(np.float32), rng)


def _mask(rng, b, nk, kind):
    if kind is None:
        return None
    if kind == "ragged":
        lengths = rng.randint(1, nk + 1, (b,))
        return np.arange(nk)[None, :] < lengths[:, None]
    mask = rng.rand(b, nk) < 0.5          # "holes": random keys, row 0 all masked
    mask[0] = False
    return mask


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("nq,nk,mask", [(16, 16, "ragged"), (81, 81, "ragged"), (5, 81, "holes"),
                                        (33, 47, "holes"), (21, 40, None)])
def test_flash_plain_matches_jax_kernel(causal, nq, nk, mask):
    q, k, v, rng = _qkv(0, 2, 2, nq, nk, 16)
    km = _mask(rng, 2, nk, mask)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               k_mask=None if km is None else jnp.asarray(km), causal=causal,
                               block_q=16, interpret=True)
    tq, tk, tv, tm = _t(q, k, v, km)
    got = tfa.flash_attention_plain(tq, tk, tv, k_mask=tm, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    if km is not None and not km[0].any():
        np.testing.assert_array_equal(got[0].numpy(), 0.0)  # no valid key: zeros, not NaN


def test_flash_fully_masked_rows_are_zero_with_finite_grads():
    q, k, v, _ = _qkv(2, 2, 2, 8, 8, 8)
    km = np.stack([np.zeros(8, bool), np.ones(8, bool)])
    tq, tk, tv, tm = _t(q, k, v, km)
    tq.requires_grad_(True)
    out = tfa.flash_attention(tq, tk, tv, k_mask=tm)
    np.testing.assert_array_equal(out[0].detach().numpy(), 0.0)
    (g,) = torch.autograd.grad(out.square().sum(), tq)
    assert torch.isfinite(g).all()
    np.testing.assert_array_equal(g[0].numpy(), 0.0)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("nq,nk", [(24, 24), (13, 30)])
def test_flash_autograd_matches_jax_grad(causal, nq, nk):
    q, k, v, rng = _qkv(3, 2, 2, nq, nk, 8)
    km = _mask(rng, 2, nk, "holes")
    w = rng.randn(2, 2, nq, 8).astype(np.float32)

    def jloss(q_, k_, v_):
        out = jfa.flash_attention(q_, k_, v_, k_mask=jnp.asarray(km), causal=causal, block_q=8,
                                  interpret=True)
        return jnp.sum(out * out * jnp.asarray(w))

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv, tm, tw = _t(q, k, v, km, w)
    leaves = [t.requires_grad_(True) for t in (tq, tk, tv)]
    out = tfa.flash_attention(tq, tk, tv, k_mask=tm, causal=causal)
    got = torch.autograd.grad((out * out * tw).sum(), leaves)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_plain_matches_autograd_through_dense_sdpa(causal):
    q, k, v, rng = _qkv(4, 2, 3, 19, 19, 8)
    km = _mask(rng, 2, 19, "holes")
    g = rng.randn(2, 3, 19, 8).astype(np.float32)
    tq, tk, tv, tm, tg = _t(q, k, v, km, g)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    bnhd = [t.transpose(1, 2) for t in leaves]
    ref = tattn.sdpa(*bnhd, tattn.build_mask(19, 19, causal=causal, k_mask=tm)).transpose(1, 2)
    want = torch.autograd.grad(ref, leaves, tg)
    got = tfa.flash_attention_bwd_plain(tq, tk, tv, tg, k_mask=tm, causal=causal)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5, err_msg=name)


def test_flash_fwd_wrapper_returns_row_statistics():
    q, k, v, rng = _qkv(5, 1, 2, 9, 11, 8)
    km = _mask(rng, 1, 11, "holes")
    km[0, 3] = True
    out, m, inv = tfa.flash_attention_fwd(*_t(q, k, v), k_mask=torch.from_numpy(km))
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(8.0) + np.where(km, 0.0, -1e30)[:, None, None]
    np.testing.assert_allclose(m.numpy(), s.max(-1), rtol=1e-5)
    np.testing.assert_allclose(inv.numpy(), 1.0 / np.exp(s - s.max(-1, keepdims=True)).sum(-1),
                               rtol=1e-5)
    assert out.shape == (1, 2, 9, 8)


def test_flash_wrappers_refuse_other_devices_and_shapes():
    meta = torch.empty((1, 2, 4, 8), device="meta")
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(meta, meta, meta)
    with pytest.raises(ValueError):
        tfa.flash_attention(torch.zeros(1, 2, 4, 8), torch.zeros(1, 2, 4, 4), torch.zeros(1, 2, 4, 4))
    with pytest.raises(ValueError):
        tfa.flash_attention_bwd(*(torch.zeros(1, 2, 4, 8),) * 4, torch.zeros(1, 2, 3),
                                torch.zeros(1, 2, 4))


@pytest.mark.parametrize("n,causal,flash", [(257, False, True), (257, True, True),
                                            (81, False, False)])
def test_attend_routes_and_matches_jax_attend(n, causal, flash, monkeypatch):
    """At Nq = Nk >= 256 and Dh = 64 the port's attend takes the flash route
    (the plain twin on the CPU); the JAX attend runs its dense path on the
    CPU. Below the cut the port stays dense."""
    rng = np.random.RandomState(6)
    q, k, v = (rng.randn(1, n, 1, 64).astype(np.float32) for _ in range(3))
    km = np.arange(n)[None, :] < n - 40
    want = jattn.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                        k_mask=jnp.asarray(km))
    calls = []
    plain = tattn.flash_attention_plain
    monkeypatch.setattr(tattn, "flash_attention_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    tq, tk, tv, tm = _t(q, k, v, km)
    got = tattn.attend(tq, tk, tv, causal=causal, k_mask=tm)
    assert bool(calls) == flash
    assert got.shape == (1, n, 1, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The bf16 wgmma forward's arithmetic (csrc/flash_attention_fwd.cuh:
# flash_fwd_wg_kernel) where it departs from the twins': scores in log2
# units (scale log2 e folded into one FMA before exp2), no per-score mask on
# a warp's tiles that need none, key tiles skipped per 128-row block (key
# bias) or per 64-row warpgroup (spans), an online softmax over 64-key
# tiles, and m converted back to natural units once. The twins stay the TPU kernels' arithmetic; this emulation is held
# against them at the card's bounds (bf16 2e-2, fp32 1e-4).
# ---------------------------------------------------------------------------

_LOG2E = np.float32(1.4426950408889634)
_LN2 = np.float32(0.6931471805599453)
_NEG2 = np.float32(np.float32(tfa.NEG_INF) * _LOG2E)   # the mask value in log2 units


def _fma32(a, b, c):
    """fp32 fma(a, b, c): the exact product and sum in float64, rounded once."""
    return (a.double() * b.double() + c.double()).float()


def _wg_forward(q, k, v, *, bias=None, causal=False, spans=None):
    """(out, m, inv, stats) by the wgmma kernel's formula (see above)."""
    b, h, nq, dh = q.shape
    nk = k.shape[2]
    sl2 = torch.tensor(np.float32(1.0 / np.sqrt(dh)) * _LOG2E)
    dots = torch.matmul(q.float(), k.float().transpose(-1, -2))
    rows, cols = torch.arange(nq), torch.arange(nk)
    if spans is not None:
        allow = tfa.span_mask(spans, nk)                                # (B, Nq, Nk)
    n_kt = (nk + 63) // 64
    m = torch.full((b, h, nq), -np.inf)
    l = torch.zeros((b, h, nq))
    acc = torch.zeros((b, h, nq, dh))
    stats = {"whole": 0, "masked": 0, "skipped": 0}
    for t in range(n_kt):
        k0, k1 = 64 * t, min(64 * t + 64, nk)
        d = dots[..., k0:k1]
        full = k1 - k0 == 64
        if spans is None:
            bt = bias[:, k0:k1]                                         # (B, kt)
            key_need = (bt > 0.5 * tfa.NEG_INF).any(-1)                 # (B,)
            row_need = (k0 <= rows) if causal else torch.ones(nq, dtype=torch.bool)
            need = key_need[:, None] & torch.stack(
                [row_need[g:g + 128].any() for g in range(0, nq, 128)]).repeat_interleave(128)[:nq][None]
            warp0 = rows // 16 * 16
            whole = (full & ~(bt != 0).any(-1))[:, None] & (
                (k0 + 63 <= warp0) if causal else torch.ones(nq, dtype=torch.bool))[None]
            s = _fma32(d, sl2, (bt * _LOG2E)[:, None, None, :])
            if causal:
                s = torch.where(cols[k0:k1][None, :] > rows[:, None], _NEG2, s)
        else:
            at = allow[..., k0:k1]                                      # (B, Nq, kt)
            grp = torch.arange(nq) // 64
            need = torch.stack([at[:, grp == g].any(-1).any(-1) for g in range(grp.max() + 1)],
                               -1)[:, grp]                              # (B, Nq)
            rw = at.all(-1) & full                                      # rows past Nq: none
            pad = (-nq) % 16
            rw = torch.cat([rw, torch.zeros((b, pad), dtype=torch.bool)], 1)
            whole = rw.view(b, -1, 16).all(-1).repeat_interleave(16, 1)[:, :nq]
            s = torch.where(at[:, None], d * sl2, _NEG2)
        need, whole = need[:, None], whole[:, None]                     # over heads
        stats["skipped"] += int((~need).sum())
        stats["whole"] += int((need & whole).sum())
        stats["masked"] += int((need & ~whole).sum())
        mx = torch.where(whole, d.amax(-1) * sl2, s.amax(-1))
        m_new = torch.maximum(m, mx)
        alpha = torch.exp2(m - m_new)
        e = torch.where(whole[..., None], torch.exp2(_fma32(d, sl2, -m_new[..., None])),
                        torch.exp2(s - m_new[..., None]))
        pv = torch.matmul(e.to(v.dtype).float(), v[:, :, k0:k1].float())
        m = torch.where(need, m_new, m)
        l = torch.where(need, l * alpha + e.sum(-1), l)
        acc = torch.where(need[..., None], acc * alpha[..., None] + pv, acc)
    live = m > 0.5 * _NEG2
    inv = torch.where(live, 1.0 / l, torch.zeros(()))
    out = (acc * inv[..., None]).to(q.dtype)
    return out, torch.where(live, m * _LN2, torch.tensor(tfa.NEG_INF)), inv, stats


def _wg_case(kind, size, dtype):
    """Operands, the kernel's mask arguments and the twin's masker: batch row
    0 attends nothing, row 1 has its first two key tiles masked, row 2 is a
    crop-like valid prefix (or, for spans, rows with whole windows, rows that
    attend nothing, late windows and random windows)."""
    if size == "ml32m":     # the ML-32M step's layer-0 magnitudes as max-abs: |q|, |k| ~ 3, |v| ~ 10
        b, h, n, k_max, v_max = 3, 2, 801, 3.0, 10.0
    else:
        b, h, n, k_max, v_max = 3, 1, 150, None, None
    rng = np.random.RandomState(11)
    q, k, v = (torch.from_numpy(rng.randn(b, h, n, 64).astype(np.float32)) for _ in range(3))
    if k_max is not None:
        q, k, v = (t * (mx / t.abs().max()) for t, mx in ((q, k_max), (k, k_max), (v, v_max)))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    if kind == "span":
        lo = rng.randint(0, n - 40, (b, n))
        hi = lo + rng.randint(1, 40, (b, n))
        ex = rng.randint(-1, n, (b, n))
        lo[:, :16], hi[:, :16], ex[:, :16] = 0, n, -1        # whole windows
        lo[:, 16:40], hi[:, 16:40], ex[:, 16:40] = 0, 0, -1  # rows that attend nothing
        lo[:, 40:70], hi[:, 40:70], ex[:, 40:70] = 130, n, -1  # first two tiles masked
        lo[0], hi[0], ex[0] = 0, 0, -1
        spans = tuple(torch.from_numpy(a.astype(np.int32)) for a in (lo, hi, ex))
        return (q, k, v), dict(spans=spans), tfa._span_masker(*spans)
    km = np.zeros((b, n), bool)
    km[1, 130:] = True
    km[2, :1 + 4 * (n // 8)] = True
    bias = tfa.mask_bias(torch.from_numpy(km), b, n, "cpu")
    causal = kind == "causal"
    return (q, k, v), dict(bias=bias, causal=causal), tfa._key_masker(bias, causal)


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize("size", ["ml32m", "small"])
@pytest.mark.parametrize("kind", ["key", "causal", "span"])
def test_wgmma_forward_arithmetic_matches_the_twin(kind, size, dtype, tol):
    (q, k, v), args, masker = _wg_case(kind, size, dtype)
    out, m, inv, stats = _wg_forward(q, k, v, **args)
    want_out, want_m, want_inv = tfa._plain_fwd(q, k, v, masker)
    assert stats["whole"] > 0 and stats["masked"] > 0 and stats["skipped"] > 0
    torch.testing.assert_close(out.float(), want_out.float(), rtol=tol, atol=tol)
    live = want_m > 0.5 * tfa.NEG_INF
    assert bool((~live).any()) and bool(live.any())
    assert torch.equal(live, m > 0.5 * tfa.NEG_INF)
    assert bool((m[~live] == tfa.NEG_INF).all()) and bool((inv[~live] == 0).all())
    assert bool((out[~live] == 0).all())                  # rows with no allowed key: exactly 0
    m_err = float((m - want_m)[live].abs().max())
    assert m_err <= 1e-5 * float(want_m[live].abs().max())
    inv_rel = float(((inv - want_inv) / want_inv)[live].abs().max())
    assert inv_rel <= (1e-3 if dtype == torch.bfloat16 else 1e-5)
