"""The port's stage-1 model pieces against the JAX package on the CPU: the
losses, the three training estimators of ``quantize.apply``, the fused
``rq_quantize_train`` Function (its plain twin on the CPU) against the
Pallas kernel in interpret mode, the model's training forward on both
routes, k-means and k-means priming.

Parameters come from the JAX ``rqvae.init`` and cross as numpy; inputs and
noise are numpy-seeded (the Gumbel estimator gets JAX's own uniform draws).
Tolerances: losses 1e-6 (values and gradients); estimator values 1e-5 and
gradients 1e-4 of each leaf's max-abs (the Gumbel softmax at t = 0.2 scales
the distances' and the logs' rounding by 5 inside an exp); the fused
Function at the JAX kernel test's own tolerances (values rtol 1e-5,
gradients rtol 2e-4 / atol 5e-5); the model forward 1e-5 and gradients 1e-4
of each leaf's max-abs (fp32 sums taken in another order); k-means
centroids 1e-5 with identical assignments.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.models import kmeans as jkm
from rqvae_tpu.models import losses as jlosses
from rqvae_tpu.models import quantize as jq
from rqvae_tpu.models import rqvae as jrq
from rqvae_tpu.ops import quantize_pallas
from rqvae_tpu_torch.models import convert, kmeans as tkm
from rqvae_tpu_torch.models import losses as tlosses
from rqvae_tpu_torch.models import quantize as tq
from rqvae_tpu_torch.models import rqvae as trq
from rqvae_tpu_torch.ops import quantize_kernels
from rqvae_tpu_torch.utils.tree import tree_leaves_with_path

from test_torch_kernels import near_tie_rows

K, D, IN, L = 32, 16, 24, 3
MODES = ["STE", "ROTATION_TRICK"]


def model_cfgs(mode="ROTATION_TRICK", n_cat=4):
    kw = dict(input_dim=IN, embed_dim=D, hidden_dims=(18, 18), codebook_size=K, n_layers=L,
              n_cat_feats=n_cat, codebook_mode=mode)
    return jrq.RqVaeConfig(**kw), trq.RqVaeConfig(**kw)


def spread_params(seed=0):
    """JAX init with each level's codebook re-drawn N(0, 1) at its residual's
    scale (U(0, 1) codebooks against an untrained encoder put every row on
    one code); returns the numpy tree."""
    jcfg, _ = model_cfgs()
    p = jax.device_get(jrq.init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.RandomState(seed + 100)
    res = np.asarray(jrq.encode(p, jcfg, jnp.asarray(inputs(256, seed + 200))))
    for level in p["layers"]:
        level["codebook"] = (rng.randn(K, D) * res.std()).astype(np.float32)
        dist = ((res[:, None] - level["codebook"][None]) ** 2).sum(-1)
        res = res - level["codebook"][dist.argmin(1)]
    return p


def inputs(b, seed, n_cat=4):
    """Dense features plus a 0/1 categorical tail (the BCE targets)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, IN).astype(np.float32)
    x[:, IN - n_cat:] = rng.randint(0, 2, (b, n_cat))
    return x


@pytest.fixture(scope="module")
def params():
    p = spread_params()
    return jax.tree.map(jnp.asarray, p), p


def tparams(np_tree):
    return convert.from_numpy(np_tree, device="cpu")


def leaves(tree):
    return [(p, np.asarray(x.detach() if isinstance(x, torch.Tensor) else x))
            for p, x in tree_leaves_with_path(tree)]


def assert_leaves_close(got, want, rel):
    got, want = leaves(got), leaves(jax.device_get(want))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        scale = max(float(np.abs(b).max()), 1e-12)
        assert np.abs(a - b).max() <= rel * scale, (path, float(np.abs(a - b).max()), scale)


def assert_close_rel(got, want, rel):
    """max |got - want| <= rel * max |want|."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert np.abs(got - want).max() <= rel * np.abs(want).max(), \
        (float(np.abs(got - want).max()), float(np.abs(want).max()))


def grads_of(fn, *tensors):
    leaves_ = [torch.from_numpy(np.array(t)).requires_grad_(True) for t in tensors]
    value = fn(*leaves_)
    return value.detach(), torch.autograd.grad(value, leaves_)


# ---- losses ----

@pytest.mark.parametrize("n_cat", [0, 5])
def test_losses_values_and_gradients_match_jax(n_cat):
    rng = np.random.RandomState(1)
    x_hat, x = rng.randn(2, 12, 20).astype(np.float32)
    x[:, 20 - n_cat:] = rng.randint(0, 2, (12, n_cat))
    q, v = rng.randn(2, 12, 8).astype(np.float32)
    w = rng.randn(12).astype(np.float32)

    def jloss(x_hat, q, v):
        return (jnp.sum(jlosses.categorical_reconstruction_loss(x_hat, jnp.asarray(x), n_cat) * w)
                + jnp.sum(jlosses.quantize_loss(q, v, 0.25) * w))

    def tloss(x_hat, q, v):
        tw = torch.from_numpy(w)
        return (torch.sum(tlosses.categorical_reconstruction_loss(x_hat, torch.from_numpy(x), n_cat) * tw)
                + torch.sum(tlosses.quantize_loss(q, v, 0.25) * tw))

    want, jgrads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2)))(x_hat, q, v)
    got, tgrads = grads_of(tloss, x_hat, q, v)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    for a, b in zip(tgrads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    # the stop-gradients: the codebook side gets 2 (v - q), the query side 2 beta (q - v)
    _, (gq, gv) = grads_of(lambda q, v: tlosses.quantize_loss(q, v, 0.25).sum(), q, v)
    np.testing.assert_allclose(gv.numpy(), 2 * (v - q), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gq.numpy(), 0.5 * (q - v), rtol=1e-6, atol=1e-6)


# ---- quantize.apply(training=True) ----

def _level_case(seed=2, b=40):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, D).astype(np.float32)
    cb = rng.randn(K, D).astype(np.float32)
    w = rng.randn(D, 4).astype(np.float32)
    return x, cb, w


@pytest.mark.parametrize("mode", MODES + ["GUMBEL_SOFTMAX"])
def test_quantize_apply_training_matches_jax(mode):
    x, cb, w = _level_case()
    key = jax.random.PRNGKey(3)
    uniform = np.asarray(jax.random.uniform(key, (x.shape[0], K), dtype=jnp.float32))

    def jfn(x, cb):
        out = jq.apply({"codebook": cb}, x, temperature=0.2, mode=jq.QuantizeForwardMode[mode],
                       commitment_weight=0.25, training=True, rng=key)
        z = out.embeddings @ w
        return jnp.sum(z * z) + jnp.mean(out.loss), (out.embeddings, out.ids, out.loss)

    def tfn(x, cb):
        out = tq.apply({"codebook": cb}, x, temperature=0.2, mode=tq.QuantizeForwardMode[mode],
                       commitment_weight=0.25, training=True, uniform=torch.from_numpy(uniform.copy()))
        z = out.embeddings @ torch.from_numpy(w)
        tfn.out = out
        return torch.sum(z * z) + torch.mean(out.loss)

    (want, jout), jgrads = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True))(x, cb)
    got, tgrads = grads_of(tfn, x, cb)
    np.testing.assert_array_equal(tfn.out.ids.numpy(), np.asarray(jout[1]))
    # values to 1e-5 of their max-abs: the Gumbel softmax at t = 0.2 scales
    # the distances' rounding by 5 inside an exp
    assert_close_rel(tfn.out.embeddings, jout[0], 1e-5)
    assert_close_rel(tfn.out.loss, jout[2], 1e-5)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for a, b in zip(tgrads, jgrads):
        assert_close_rel(a, b, 1e-4)


def test_gumbel_needs_noise_and_draws_from_the_generator():
    x, cb, _ = _level_case()
    kw = dict(mode=tq.QuantizeForwardMode.GUMBEL_SOFTMAX, training=True)
    with pytest.raises(ValueError):
        tq.apply({"codebook": torch.from_numpy(cb)}, torch.from_numpy(x), **kw)
    a, b = (tq.apply({"codebook": torch.from_numpy(cb)}, torch.from_numpy(x),
                     generator=torch.Generator().manual_seed(s), **kw).embeddings for s in (1, 2))
    assert torch.isfinite(a).all() and not torch.equal(a, b)


# ---- the fused training Function ----

@pytest.mark.parametrize("mode", MODES)
def test_rq_quantize_train_twin_matches_pallas_kernel(mode):
    rng = np.random.RandomState(4)
    x = rng.randn(48, D).astype(np.float32)
    cbs = (rng.randn(L, K, D) * np.array([1.0, 0.6, 0.4])[:, None, None]).astype(np.float32)
    w = rng.randn(D, 4).astype(np.float32)

    def jfn(x, cbs):
        out = quantize_pallas.rq_quantize_train(x, cbs, mode, 0.25, 512, True)
        z = jnp.sum(out.embeddings, axis=-1) @ w
        return (jnp.mean(jnp.sum(z * z, axis=-1)) + jnp.mean(out.quantize_loss)
                + 0.1 * jnp.mean(jnp.sum(out.residuals ** 2, axis=(1, 2)))), out

    def tfn(x, cbs):
        out = quantize_kernels.rq_quantize_train(x, cbs, mode, 0.25)
        z = torch.sum(out.embeddings, dim=-1) @ torch.from_numpy(w)
        tfn.out = out
        return (torch.mean(torch.sum(z * z, dim=-1)) + torch.mean(out.quantize_loss)
                + 0.1 * torch.mean(torch.sum(out.residuals ** 2, dim=(1, 2))))

    (want, jout), jgrads = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(x, cbs)
    got, tgrads = grads_of(tfn, x, cbs)
    wid = np.asarray(jout.sem_ids)
    differ = (tfn.out.sem_ids.numpy() != wid).any(1)
    assert not (differ & ~near_tie_rows(x, cbs, wid)).any()
    assert not differ.any(), "a near-tie flipped an id: the gradients below would not compare"
    assert len(np.unique(wid[:, 0])) > 8
    for name in ("embeddings", "residuals", "quantize_loss"):
        np.testing.assert_allclose(getattr(tfn.out, name).detach().numpy(),
                                   np.asarray(getattr(jout, name)), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    assert tfn.out.sem_ids.dtype == torch.int32 and tfn.out.embeddings.shape == (48, D, L)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for a, b in zip(tgrads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=5e-5)


def test_rq_quantize_train_refuses_bad_modes_shapes_and_devices():
    x, cbs = torch.zeros(4, 8), torch.zeros(2, 16, 8)
    with pytest.raises(ValueError):
        quantize_kernels.rq_quantize_train(x, cbs, "GUMBEL_SOFTMAX")
    with pytest.raises(ValueError):
        quantize_kernels.rq_quantize_train(x, torch.zeros(2, 16, 4))
    with pytest.raises(ValueError):
        quantize_kernels.rq_quantize_train(torch.empty((4, 8), device="meta"),
                                           torch.empty((2, 16, 8), device="meta"))


# ---- the model's training forward ----

def _jax_forward_and_grads(jp, jcfg, x):
    def loss_fn(p, x):
        out = jrq.forward(p, jcfg, x, gumbel_t=0.2, training=True)
        return out.loss, out
    (_, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jp, jnp.asarray(x))
    return out, grads


@pytest.mark.parametrize("route", ["plain", "fused"])
@pytest.mark.parametrize("mode", MODES)
def test_forward_training_matches_jax_plain_route(params, route, mode, monkeypatch):
    jcfg, tcfg = model_cfgs(mode)
    jp, np_tree = params
    x = inputs(48, 5)
    want, jgrads = _jax_forward_and_grads(jp, jcfg, x)
    monkeypatch.setattr(trq, "FUSED_TRAIN_MIN_CODEBOOK_VOLUME",
                        0 if route == "fused" else float("inf"))
    calls = []
    real = trq._fused_train_quantize
    monkeypatch.setattr(trq, "_fused_train_quantize", lambda *a: calls.append(1) or real(*a))
    tp = [t.requires_grad_(True) for _, t in tree_leaves_with_path(tparams(np_tree))]
    tree = trq_tree(np_tree, tp)
    got = trq.forward(tree, tcfg, torch.from_numpy(x), gumbel_t=0.2, training=True)
    assert len(calls) == (route == "fused")
    tgrads = torch.autograd.grad(got.loss, tp)
    for name in ("loss", "reconstruction_loss", "rqvae_loss", "embs_norm", "p_unique_ids"):
        np.testing.assert_allclose(getattr(got, name).detach().numpy(),
                                   np.asarray(getattr(want, name)), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    assert 0.2 < float(got.p_unique_ids) <= 1.0
    assert_leaves_close(trq_tree(np_tree, tgrads), jgrads, 1e-4)


def trq_tree(np_tree, leaves_):
    from rqvae_tpu_torch.utils.tree import tree_unflatten

    return tree_unflatten(np_tree, list(leaves_))


def test_eval_forward_matches_jax(params):
    jcfg, tcfg = model_cfgs()
    jp, np_tree = params
    x = inputs(32, 6)
    want = jax.jit(lambda p, x: jrq.forward(p, jcfg, x, gumbel_t=0.2))(jp, jnp.asarray(x))
    got = trq.forward(tparams(np_tree), tcfg, torch.from_numpy(x), gumbel_t=0.2)
    for name in ("loss", "reconstruction_loss", "rqvae_loss", "p_unique_ids"):
        np.testing.assert_allclose(float(getattr(got, name)), float(getattr(want, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


# ---- k-means ----

def _clustered(seed, n=240, k=8, dim=6):
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, dim) * 3.0
    return (centers[rng.randint(0, k, n)] + 0.3 * rng.randn(n, dim)).astype(np.float32)


def test_kmeans_from_jaxs_initial_centroids_matches_jax():
    x = _clustered(7)
    k = 8
    key = jax.random.PRNGKey(11)
    _, init_key = jax.random.split(key)
    init_idx = np.asarray(jax.random.choice(init_key, x.shape[0], (k,), replace=False))
    want = jkm.kmeans(key, jnp.asarray(x), k)
    tx = torch.from_numpy(x)
    got = tkm.refine(tx, tx[torch.from_numpy(init_idx.copy()).long()],
                     torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(got.assignment.numpy(), np.asarray(want.assignment))
    assert len(np.unique(got.assignment.numpy())) == k  # no empty cluster at the end
    np.testing.assert_allclose(got.centroids.numpy(), np.asarray(want.centroids),
                               rtol=1e-5, atol=1e-5)
    # its own draw: k distinct rows, converged
    own = tkm.kmeans(torch.from_numpy(x), k, generator=torch.Generator().manual_seed(1))
    assert own.centroids.shape == (k, 6) and torch.isfinite(own.centroids).all()


def test_kmeans_reseeds_an_empty_cluster_from_a_data_row():
    x = torch.from_numpy(_clustered(8, n=30, k=3))
    c0 = torch.stack([x[0], x[1], torch.full((6,), 1e3)])  # nothing is near the third
    out = tkm.refine(x, c0, torch.Generator().manual_seed(2), max_iters=1)
    assert (out.centroids[2][None] == x).all(dim=1).any()
    for c in range(2):  # the others are their clusters' means
        members = x[(tkm._assign(x, c0) == c)]
        np.testing.assert_allclose(out.centroids[c].numpy(), members.mean(0).numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_kmeans_prime_feeds_each_level_the_previous_training_residuals(params, monkeypatch):
    jcfg, tcfg = model_cfgs()
    jp, np_tree = params
    x = inputs(2 * K, 9)

    def pair_means(x, k):  # deterministic stand-in: residuals are never zero
        return 0.5 * (x[:k] + x[k:2 * k])

    monkeypatch.setattr(jrq.kmeans_lib, "kmeans", lambda rng, x, k: jkm.KmeansOutput(
        pair_means(x, k), jnp.zeros(x.shape[0], jnp.int32)))
    monkeypatch.setattr(trq.kmeans_lib, "kmeans", lambda x, k, generator: tkm.KmeansOutput(
        pair_means(x, k), torch.zeros(x.shape[0], dtype=torch.int32)))
    want = jrq.kmeans_prime(jp, jcfg, jnp.asarray(x), jax.random.PRNGKey(0), gumbel_t=0.2)
    got = trq.kmeans_prime(tparams(np_tree), tcfg, torch.from_numpy(x),
                           torch.Generator().manual_seed(0), gumbel_t=0.2)
    for level in range(L):
        np.testing.assert_allclose(got["layers"][level]["codebook"].numpy(),
                                   np.asarray(want["layers"][level]["codebook"]),
                                   rtol=1e-5, atol=1e-5, err_msg=f"level {level}")
    assert got["encoder"][0] is not None


def test_kmeans_prime_runs_real_kmeans_per_level(params):
    _, tcfg = model_cfgs()
    _, np_tree = params
    tp = tparams(np_tree)
    x = torch.from_numpy(inputs(200, 10))
    primed = trq.kmeans_prime(tp, tcfg, x, torch.Generator().manual_seed(3))
    res = trq.encode(tp, tcfg, x)
    cb0 = primed["layers"][0]["codebook"]
    assert cb0.shape == (K, D) and torch.isfinite(cb0).all()
    # level 0's codebook are cluster means of the encoder outputs: every code is used
    assert len(torch.unique(tq.distances(res, cb0).argmin(-1))) == K
    assert primed["encoder"] is tp["encoder"]
