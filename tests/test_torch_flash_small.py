"""The port's short-sequence attention (``flash_attention_small`` and its
twins) and ``attend``'s short route against the JAX package.

On the CPU the wrappers run their plain PyTorch twins (the CUDA kernels
build and run on the GPU only; ``chip_smoke.py`` holds them against these
twins there). The JAX short kernel runs in interpret mode, as
tests/test_flash_attention.py runs it. Inputs are numpy-seeded. Tolerances
are the JAX tests' own: fp32 2e-5 on values and 1e-4 on gradients; bf16
2e-2 (both sides round e and ds to bf16 at the same points, so only fp32
sums taken in other orders differ). The routed train step: loss 1e-4
relative, every gradient leaf 1e-3 of its max-abs (two packages' fp32 sums
over four layers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rqvae_tpu.data.schemas import SeqBatch as JSeqBatch
from rqvae_tpu.models import retrieval as jret
from rqvae_tpu.ops import attention as jattn
from rqvae_tpu.ops import flash_attention as jfa
from rqvae_tpu.tokenizer import semids as jsem
from rqvae_tpu.train import train_decoder as jtd
from rqvae_tpu_torch.data.schemas import SeqBatch as TSeqBatch
from rqvae_tpu_torch.models import convert
from rqvae_tpu_torch.models import retrieval as tret
from rqvae_tpu_torch.ops import attention as tattn
from rqvae_tpu_torch.ops import flash_attention as tfa
from rqvae_tpu_torch.tokenizer import semids as tsem
from rqvae_tpu_torch.train import train_decoder as ttd
from rqvae_tpu_torch.utils.tree import tree_leaves_with_path


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


SHAPES = [(16, 16, True, "ragged"), (16, 16, False, "holes"), (81, 81, True, "ragged"),
          (81, 81, False, "holes"), (5, 81, False, "ragged"), (13, 13, True, "holes"),
          (1, 3, False, None), (21, 40, False, "ragged")]


@pytest.mark.parametrize("nq,nk,causal,mask", SHAPES)
def test_small_twins_match_jax_kernel_values_and_gradients(nq, nk, causal, mask):
    q, k, v, rng = _qkv(0, 2, 2, nq, nk, 16)
    km = _mask(rng, 2, nk, mask)
    w = rng.randn(2, 2, nq, 16).astype(np.float32)
    jkm = None if km is None else jnp.asarray(km)

    def jloss(q_, k_, v_):
        out = jfa.flash_attention_small(q_, k_, v_, k_mask=jkm, causal=causal, interpret=True)
        return jnp.sum(out * out * jnp.asarray(w)), out

    (_, want), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv, tm, tw = _t(q, k, v, km, w)
    np.testing.assert_allclose(tfa.flash_attention_small_plain(tq, tk, tv, k_mask=tm, causal=causal)
                               .numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    leaves = [t.requires_grad_(True) for t in (tq, tk, tv)]
    out = tfa.flash_attention_small(tq, tk, tv, k_mask=tm, causal=causal)
    got = torch.autograd.grad((out * out * tw).sum(), leaves)
    for name, a, b in zip("qkv", got, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4, err_msg=name)
    if km is not None and not km[0].any():
        np.testing.assert_array_equal(out[0].detach().numpy(), 0.0)   # no valid key: zeros
        np.testing.assert_array_equal(got[0][0].numpy(), 0.0)


def test_small_bwd_twin_matches_jax_backward_directly():
    """The backward twin on an upstream gradient, against the JAX kernel's
    vjp (not through autograd of the forward twin)."""
    q, k, v, rng = _qkv(1, 2, 3, 21, 40, 16)
    km = _mask(rng, 2, 40, "holes")
    g = rng.randn(2, 3, 21, 16).astype(np.float32)
    _, vjp = jax.vjp(lambda q_, k_, v_: jfa.flash_attention_small(
        q_, k_, v_, k_mask=jnp.asarray(km), interpret=True), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    got = tfa.flash_attention_small_bwd_plain(*_t(q, k, v, g), k_mask=torch.from_numpy(km))
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("nq,nk,causal", [(81, 81, False), (5, 81, False), (13, 13, True)])
def test_small_twins_match_jax_kernel_in_bf16(nq, nk, causal):
    q, k, v, rng = _qkv(2, 2, 2, nq, nk, 64)
    km = _mask(rng, 2, nk, "ragged")
    g = rng.randn(2, 2, nq, 64).astype(np.float32)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)   # noqa: E731
    jq, jk, jv, jg = map(bf, (q, k, v, g))
    want, vjp = jax.vjp(lambda q_, k_, v_: jfa.flash_attention_small(
        q_, k_, v_, k_mask=jnp.asarray(km), causal=causal, interpret=True), jq, jk, jv)
    want_grads = vjp(jg)
    tb = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
          for a in (jq, jk, jv, jg)]
    tm = torch.from_numpy(km)
    out = tfa.flash_attention_small_plain(*tb[:3], k_mask=tm, causal=causal)
    grads = tfa.flash_attention_small_bwd_plain(*tb, k_mask=tm, causal=causal)
    for name, a, b in (("out", out, want),) + tuple(zip(("dq", "dk", "dv"), grads, want_grads)):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b.astype(jnp.float32)),
                                   rtol=2e-2, atol=2e-2, err_msg=name)


def test_small_wrappers_return_row_statistics_and_refuse_long_shapes():
    q, k, v, rng = _qkv(3, 1, 2, 9, 11, 8)
    km = _mask(rng, 1, 11, "holes")
    km[0, 3] = True
    out, m, inv = tfa.flash_attention_small_fwd(*_t(q, k, v), k_mask=torch.from_numpy(km))
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(8.0) + np.where(km, 0.0, -1e30)[:, None, None]
    np.testing.assert_allclose(m.numpy(), s.max(-1), rtol=1e-5)
    np.testing.assert_allclose(inv.numpy(), 1.0 / np.exp(s - s.max(-1, keepdims=True)).sum(-1),
                               rtol=1e-5)
    assert out.shape == (1, 2, 9, 8)
    long_q = torch.zeros(1, 2, 256, 8)
    short = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match="255"):
        tfa.flash_attention_small_fwd(long_q, short, short)
    with pytest.raises(ValueError, match="255"):
        tfa.flash_attention_small(short, long_q, long_q)
    with pytest.raises(ValueError, match="255"):
        tfa.flash_attention_small_bwd(short, long_q, long_q, short, torch.zeros(1, 2, 4),
                                      torch.zeros(1, 2, 4))
    meta = torch.empty((1, 2, 4, 8), device="meta")
    with pytest.raises(ValueError):
        tfa.flash_attention_small_fwd(meta, meta, meta)


ROUTES = [  # (nq, nk, dh, switch, spans, expected route)
    (81, 81, 64, "1", False, "small"), (5, 81, 64, "1", False, "small"),
    (1, 3, 64, "1", False, "small"), (255, 40, 64, "1", False, "small"),
    (81, 81, 32, "1", False, "dense"), (257, 257, 64, "1", False, "flash"),
    (81, 81, 64, None, False, "dense"), (81, 81, 64, "0", False, "dense"),
    (81, 81, 64, "1", True, "dense"), (257, 257, 64, "1", True, "spans"),
    (5, 120, 64, "1", False, "small"), (120, 120, 64, "1", False, "small"),   # long keys
]


@pytest.mark.parametrize("nq,nk,dh,switch,spans,route", ROUTES)
def test_attend_short_route_and_jax_parity(nq, nk, dh, switch, spans, route, monkeypatch):
    """The short route fires only for Nq, Nk < 256 with Dh >= 64 and the
    switch set; spans, long shapes and Dh < 64 keep their routes. The
    output equals JAX's ``attend`` with the Pallas kernels forced on (the
    short kernel in interpret mode) under the same switch."""
    if switch is None:
        monkeypatch.delenv("RQVAE_TPU_SHORT_FLASH", raising=False)
    else:
        monkeypatch.setenv("RQVAE_TPU_SHORT_FLASH", switch)
    monkeypatch.setenv("RQVAE_TPU_FORCE_PALLAS", "1")
    rng = np.random.RandomState(7)
    q = rng.randn(2, nq, 2, dh).astype(np.float32)
    k, v = (rng.randn(2, nk, 2, dh).astype(np.float32) for _ in range(2))
    causal = nq == nk and not spans
    km = None if spans else np.arange(nk)[None, :] < np.array([[nk], [max(1, nk - 7)]])
    q_spans = None
    if spans:
        lo = np.minimum(np.arange(nq) // 2, nk - 1)[None].repeat(2, 0).astype(np.int32)
        q_spans = (lo, np.minimum(lo + 9, nk).astype(np.int32), np.full((2, nq), -1, np.int32))
    want = jattn.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                        k_mask=None if km is None else jnp.asarray(km),
                        q_spans=None if q_spans is None else tuple(map(jnp.asarray, q_spans)))
    calls = []
    for name in ("flash_attention_small_plain", "flash_attention_plain",
                 "flash_attention_spans_plain"):
        real = getattr(tattn, name)
        monkeypatch.setattr(tattn, name, lambda *a, _n=name, _r=real, **kw:
                            calls.append(_n) or _r(*a, **kw))
    got = tattn.attend(*_t(q, k, v), causal=causal, k_mask=None if km is None else _t(km)[0],
                       q_spans=None if q_spans is None else tuple(_t(*q_spans)))
    expected = {"small": ["flash_attention_small_plain"], "flash": ["flash_attention_plain"],
                "spans": ["flash_attention_spans_plain"], "dense": []}[route]
    assert calls == expected
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


# ---- a tiny Amazon-shaped train step with the switch on ----
K = 16
N_HIST = 20    # 81 encoder tokens, 5 decoder tokens: every call short
N_ITEMS = 60
JCFG = jret.RetrievalConfig(
    embedding_dim=16, attn_dim=128, dropout=0.0, num_heads=2, n_layers=4, num_embeddings=K,
    sem_id_dim=4, max_pos=N_HIST * 4, input_dropout=0.0, mlp_hidden_dim=64,
)
TCFG = tret.RetrievalConfig(**{f: getattr(JCFG, f) for f in JCFG.__dataclass_fields__})
JCAPTURE = optax.GradientTransformation(
    lambda p: None, lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


class _CaptureGrads:
    """A port optimizer that leaves the params alone and keeps the grads."""

    def update(self, params, state, grads):
        return grads


def test_amazon_shaped_train_step_through_the_short_route_matches_jax(monkeypatch):
    monkeypatch.setenv("RQVAE_TPU_SHORT_FLASH", "1")
    monkeypatch.setenv("RQVAE_TPU_FORCE_PALLAS", "1")
    rng = np.random.RandomState(0)
    ids = rng.randint(0, K, (N_ITEMS, 3)).astype(np.int32)
    dedup = np.asarray(jax.jit(jsem.dedup_column, static_argnums=1)(jnp.asarray(ids), K))
    cached = np.concatenate([ids, dedup[:, None]], axis=1).astype(np.int32)
    jindex = jsem.build_index(jnp.asarray(cached), codebook_size=K)
    tindex = tsem.build_index(torch.from_numpy(cached), K)
    jp = jax.device_get(jax.jit(lambda key: jret.init(key, JCFG))(jax.random.PRNGKey(0)))
    tp = convert.from_numpy(jp, device="cpu")
    lengths = np.array([20, 20, 12, 3])
    hist = rng.randint(0, N_ITEMS, (4, N_HIST)).astype(np.int32)
    arrays = {"user_ids": np.arange(4, dtype=np.int32) * 31,
              "ids": np.where(np.arange(N_HIST)[None] < lengths[:, None], hist, -1)[None],
              "ids_fut": rng.randint(0, N_ITEMS, (1, 4, 1)).astype(np.int32)}
    arrays["user_ids"] = arrays["user_ids"][None]
    arrays["seq_mask"] = arrays["ids"] >= 0
    arrays["x"] = np.zeros(arrays["ids"].shape + (1,), np.float32)
    arrays["x_fut"] = np.zeros(arrays["ids_fut"].shape + (1,), np.float32)
    jb = JSeqBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tb = TSeqBatch(**{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()})

    jstep = jax.jit(jtd.make_train_step(JCFG, JCAPTURE, jindex, 1, jnp.float32, 4))
    _, jgrads, jm = jstep(jax.tree.map(jnp.asarray, jp), None, jb, jax.random.key(0))
    calls = []
    real = tattn.flash_attention_small_plain
    monkeypatch.setattr(tattn, "flash_attention_small_plain",
                        lambda *a, **kw: calls.append(a[0].shape) or real(*a, **kw))
    tstep = ttd.make_train_step(TCFG, _CaptureGrads(), tindex, 1, torch.float32, 4)
    _, tgrads, tm = tstep(tp, None, tb, None)
    # 2 encoder self (81 x 81), 2 decoder self (5 x 5), 2 cross (5 x 81)
    assert sorted((s[2], s[3]) for s in calls) == [(5, 64)] * 4 + [(81, 64)] * 2
    assert abs(float(tm["total_loss"]) - float(jm["total_loss"])) <= 1e-4 * abs(float(jm["total_loss"]))
    got = [(p, x.detach().numpy()) for p, x in tree_leaves_with_path(tgrads)]
    want = [(p, np.asarray(x)) for p, x in tree_leaves_with_path(jax.device_get(jgrads))]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        scale = max(float(np.abs(b).max()), 1e-12)
        assert np.abs(a - b).max() <= 1e-3 * scale, (path, float(np.abs(a - b).max()), scale)
