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
