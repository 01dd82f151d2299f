"""The port's width rule for its kernel routes, against the JAX package on the
CPU. JAX's Pallas kernels take any width; the port's CUDA kernels take
Dh <= 128 (flash) and D <= 128 (quantizers), so ``attend`` sends wider heads
to the dense ``sdpa`` and ``rqvae`` wider embeddings to the plain per-level
loop. Each case records whether the port took its kernel route (the
monkeypatched ``calls`` pattern of ``tests/test_torch_packing.py``) and
holds the result against JAX with ``RQVAE_TPU_FORCE_PALLAS=1``, so the JAX
side runs its Pallas kernels in interpret mode at every width.

Tolerances are the existing ones: attention values 2e-5 and gradients 1e-4
(``tests/test_torch_packing.py``), the RQ-VAE forward 1e-5 and gradient
leaves 1e-4 of their max-abs (``tests/test_torch_rqvae_train.py``), ids
equal off near-ties (``tests/test_torch_kernels.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.models import rqvae as jrq
from rqvae_tpu.ops import attention as jattn
from rqvae_tpu_torch.models import convert
from rqvae_tpu_torch.models import rqvae as trq
from rqvae_tpu_torch.ops import attention as tattn
from rqvae_tpu_torch.ops import flash_attention as tfa
from rqvae_tpu_torch.ops import quantize_kernels as tqk
from rqvae_tpu_torch.utils.tree import tree_leaves_with_path, tree_unflatten

from test_torch_kernels import near_tie_rows

ROUTES = {"span": "flash_attention_spans_plain", "short": "flash_attention_small_plain",
          "flat": "flash_attention_plain"}


def _attention_case(case, dh, seed=11):
    rng = np.random.RandomState(seed)
    b, h, n = 2, 2, (40 if case == "short" else 260)
    q, k, v, g = (rng.randn(b, n, h, dh).astype(np.float32) for _ in range(4))
    if case == "span":
        lo = rng.randint(0, n - 40, (b, n)).astype(np.int32)
        hi = lo + rng.randint(0, 40, (b, n)).astype(np.int32)
        extra = rng.randint(-1, n, (b, n)).astype(np.int32)
        lo[:, :3], hi[:, :3], extra[:, :3] = 0, 0, -1
        kw = {"q_spans": (lo, hi, extra)}
    else:
        kw = {"k_mask": np.arange(n)[None, :] < np.array([n, n - 25])[:, None]}
    return (q, k, v, g), kw


@pytest.mark.parametrize("dh,kernel", [(128, True), (256, False)])
@pytest.mark.parametrize("case", ["span", "short", "flat"])
def test_attend_routes_by_head_width_and_matches_jax(case, dh, kernel, monkeypatch):
    (q, k, v, g), kw = _attention_case(case, dh)
    monkeypatch.setenv("RQVAE_TPU_FORCE_PALLAS", "1")
    if case == "short":
        monkeypatch.setenv(tattn.SHORT_FLASH_ENV, "1")
    jkw = {name: (tuple(map(jnp.asarray, x)) if name == "q_spans" else jnp.asarray(x))
           for name, x in kw.items()}

    def jloss(q_, k_, v_):
        return (jattn.attend(q_, k_, v_, **jkw) * jnp.asarray(g)).sum()

    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = jattn.attend(jq, jk, jv, **jkw)
    want_grads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)

    calls = []
    real = getattr(tattn, ROUTES[case])
    monkeypatch.setattr(tattn, ROUTES[case], lambda *a, **k_: calls.append(1) or real(*a, **k_))
    tkw = {name: (tuple(map(torch.from_numpy, x)) if name == "q_spans" else torch.from_numpy(x))
           for name, x in kw.items()}
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    got = tattn.attend(tq, tk, tv, **tkw)
    grads = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(g))
    assert bool(calls) == kernel
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    for a, b in zip(grads, want_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)


def test_kernel_wrappers_refuse_wider_shapes():
    """The rule is a route: called directly, the kernel wrappers still raise."""
    wide = torch.zeros(1, 2, 8, 256)
    with pytest.raises(ValueError, match="Dh <= 128"):
        tfa._check_kernel_operands((wide, wide, wide), ("q", "k", "v"))
    x = torch.zeros(4, 256)
    cbs = torch.zeros(2, 8, 256)
    with pytest.raises(ValueError, match="at most 128"):
        tqk._launch("rq_tokenize", x, cbs, x, x, torch.zeros(4, 2, dtype=torch.int32),
                    torch.zeros(4), 0.25)


def _rq_cfgs(embed_dim):
    # codebook volume 65,536 at both widths: JAX's fused training route
    kw = dict(input_dim=24, embed_dim=embed_dim, hidden_dims=(32,), codebook_size=65536 // embed_dim,
              n_layers=2, n_cat_feats=0, codebook_mode="ROTATION_TRICK")
    return jrq.RqVaeConfig(**kw), trq.RqVaeConfig(**kw)


def _rq_params(jcfg, seed=3):
    """JAX init with each level's codebook drawn N(0, 1) at its residual's
    scale (as ``tests/test_torch_rqvae_train.py`` does)."""
    p = jax.device_get(jrq.init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.RandomState(seed)
    res = np.asarray(jrq.encode(p, jcfg, jnp.asarray(rng.randn(256, 24).astype(np.float32))))
    for level in p["layers"]:
        level["codebook"] = (rng.randn(*level["codebook"].shape) * res.std()).astype(np.float32)
        res = res - level["codebook"][((res[:, None] - level["codebook"][None]) ** 2).sum(-1).argmin(1)]
    return p


@pytest.mark.parametrize("embed_dim,kernel", [(64, True), (256, False)])
def test_encode_and_tokenize_routes_by_width_and_matches_jax(embed_dim, kernel, monkeypatch):
    jcfg, tcfg = _rq_cfgs(embed_dim)
    p = _rq_params(jcfg)
    x = np.random.RandomState(4).randn(64, 24).astype(np.float32)
    monkeypatch.setenv("RQVAE_TPU_FORCE_PALLAS", "1")
    want = np.asarray(jrq.encode_and_tokenize(jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(x)))
    calls = []
    real = trq.rq_tokenize
    monkeypatch.setattr(trq, "rq_tokenize", lambda *a, **k_: calls.append(1) or real(*a, **k_))
    tp = convert.from_numpy(p, device="cpu")
    got = trq.encode_and_tokenize(tp, tcfg, torch.from_numpy(x)).numpy()
    assert bool(calls) == kernel
    z = np.asarray(jrq.encode(p, jcfg, jnp.asarray(x)))
    cbs = np.stack([level["codebook"] for level in p["layers"]])
    differ = (got != want).any(axis=1)
    assert not (differ & ~near_tie_rows(z, cbs, want)).any()


@pytest.mark.parametrize("embed_dim,kernel", [(64, True), (256, False)])
def test_training_quantizer_routes_by_width_and_matches_jax(embed_dim, kernel, monkeypatch):
    jcfg, tcfg = _rq_cfgs(embed_dim)
    p = _rq_params(jcfg)
    x = np.random.RandomState(5).randn(48, 24).astype(np.float32)
    monkeypatch.setenv("RQVAE_TPU_FORCE_PALLAS", "1")

    def loss_fn(p_, x_):
        out = jrq.forward(p_, jcfg, x_, gumbel_t=0.2, training=True)
        return out.loss, out

    (_, want), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    calls = []
    real = trq.rq_quantize_train
    monkeypatch.setattr(trq, "rq_quantize_train", lambda *a, **k_: calls.append(1) or real(*a, **k_))
    leaves = [t.requires_grad_(True) for _, t in tree_leaves_with_path(convert.from_numpy(p, device="cpu"))]
    got = trq.forward(tree_unflatten(p, leaves), tcfg, torch.from_numpy(x), gumbel_t=0.2, training=True)
    grads = torch.autograd.grad(got.loss, leaves)
    assert bool(calls) == kernel
    np.testing.assert_allclose(float(got.loss.detach()), float(want.loss), rtol=1e-5, atol=1e-5)
    jleaves = [np.asarray(b) for _, b in tree_leaves_with_path(jax.device_get(jgrads))]
    for a, b in zip(grads, jleaves):
        assert np.abs(a.numpy() - b).max() <= 1e-4 * max(float(np.abs(b).max()), 1e-12)
