"""The port's counterparts of the JAX package's reference helpers, against
JAX's on the CPU with seeded numpy inputs:

* ``retrieval.forward_generate_step``: the uncached generation step, logits
  and the encoder context in fp32 (1e-5), and the port's KV-cached decode
  (``forward_generate_cached`` and ``decode_token_cached``) held against
  it at every prefix length, as JAX's ``tests/test_generation.py`` holds
  its own;
* ``semids.tokenize_items_fresh``: equal ids;
* ``semids.pack_prefix``: keys equal as integers (int64 here, uint32 there),
  ``semids.sem_ids_dim``, ``embeddings.sem_id_padding_idx`` and
  ``schemas.FUT_SUFFIX`` equal;
* ``native.available()``: True where the batcher builds, False with the
  switch off.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.data import schemas as jschemas
from rqvae_tpu.data.schemas import TokenizedSeqBatch as JBatch
from rqvae_tpu.models import embeddings as jemb
from rqvae_tpu.models import retrieval as jret
from rqvae_tpu.models import rqvae as jrq
from rqvae_tpu.tokenizer import semids as jsem
from rqvae_tpu_torch import native
from rqvae_tpu_torch.data import schemas as tschemas
from rqvae_tpu_torch.data.schemas import TokenizedSeqBatch as TBatch
from rqvae_tpu_torch.models import convert
from rqvae_tpu_torch.models import embeddings as temb
from rqvae_tpu_torch.models import retrieval as tret
from rqvae_tpu_torch.models import rqvae as trq
from rqvae_tpu_torch.tokenizer import semids as tsem

K = 8
D = 4
JCFG = jret.RetrievalConfig(embedding_dim=16, attn_dim=32, dropout=0.0, num_heads=4, n_layers=4,
                            num_embeddings=K, sem_id_dim=D, max_pos=20, input_dropout=0.0,
                            mlp_hidden_dim=64)
TCFG = tret.RetrievalConfig(**{f: getattr(JCFG, f) for f in JCFG.__dataclass_fields__})
RQ_FIELDS = dict(input_dim=24, embed_dim=8, hidden_dims=(16,), codebook_size=16, n_layers=3,
                 n_cat_feats=0)


@pytest.fixture(scope="module")
def params():
    jp = jax.jit(lambda key: jret.init(key, JCFG))(jax.random.PRNGKey(0))
    return jp, convert.from_numpy(jax.device_get(jp), device="cpu")


def _batch(b=3, n_items=4, fut_len=None, seed=1):
    """JAX's and the port's batch on the same arrays; ``fut_len`` future
    tokens (None: no future, the BOS step)."""
    rng = np.random.RandomState(seed)
    n = n_items * D
    arrays = dict(
        user_ids=np.arange(b, dtype=np.int32) * 977 - 3,
        sem_ids=rng.randint(0, K, size=(b, n)).astype(np.int32),
        seq_mask=np.ones((b, n), dtype=bool),
        token_type_ids=np.tile(np.arange(D, dtype=np.int32), (b, n_items)),
    )
    arrays["seq_mask"][0, -D:] = False
    arrays["sem_ids"][0, -D:] = -1
    if fut_len:
        arrays["sem_ids_fut"] = rng.randint(0, K, size=(b, fut_len)).astype(np.int32)
        arrays["token_type_ids_fut"] = np.tile(np.arange(fut_len, dtype=np.int32), (b, 1))
    else:
        arrays["sem_ids_fut"] = arrays["token_type_ids_fut"] = None
    conv = lambda f: {k: None if v is None else f(v) for k, v in arrays.items()}  # noqa: E731
    return JBatch(**conv(jnp.asarray)), TBatch(**conv(torch.from_numpy))


@pytest.mark.parametrize("fut_len", [None, 1, 3])
def test_forward_generate_step_matches_jax(params, fut_len):
    jp, tp = params
    jb, tb = _batch(fut_len=fut_len)
    want_logits, want_ctx = jret.forward_generate_step(jp, JCFG, jb)
    logits, ctx = tret.forward_generate_step(tp, TCFG, tb)
    assert tuple(logits.shape) == (3, K)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(want_ctx), rtol=1e-5, atol=1e-5)
    # the cached context skips the encoder and gives the same logits
    again, ctx2 = tret.forward_generate_step(tp, TCFG, tb, cached_context=ctx)
    assert ctx2 is ctx
    np.testing.assert_allclose(again.numpy(), logits.numpy(), rtol=1e-6, atol=1e-6)


def test_cached_decode_matches_forward_generate_step(params):
    """The KV-cached decode (full prefix against the cached cross K / V, and
    token by token with the self-attention cache) equals the uncached step
    at every prefix length over 2 beams a row."""
    _, tp = params
    beams = 2
    _, tb = _batch(fut_len=D)
    with torch.no_grad():
        cache = tret.encode_for_generation(tp, TCFG, tb._replace(sem_ids_fut=None,
                                                                 token_type_ids_fut=None))
        _, context = tret.forward_generate_step(tp, TCFG, tb._replace(
            sem_ids_fut=None, token_type_ids_fut=None))
        rng = np.random.RandomState(0)
        fut = torch.from_numpy(rng.randint(0, K, (3 * beams, D - 1)).astype(np.int32))
        tt = torch.arange(D - 1, dtype=torch.int32).expand(3 * beams, D - 1)
        rep = lambda t: t.repeat_interleave(beams, 0)  # noqa: E731
        self_kv = None
        for i in range(D):
            prefix = None if i == 0 else fut[:, :i]
            big = TBatch(user_ids=rep(tb.user_ids), sem_ids=rep(tb.sem_ids),
                         sem_ids_fut=prefix, seq_mask=rep(tb.seq_mask),
                         token_type_ids=rep(tb.token_type_ids),
                         token_type_ids_fut=None if i == 0 else tt[:, :i])
            ref, _ = tret.forward_generate_step(tp, TCFG, big, cached_context=rep(context))
            full = tret.forward_generate_cached(tp, TCFG, cache, prefix,
                                                None if i == 0 else tt[:, :i], beams=beams,
                                                n_rows=3 * beams)
            step, self_kv = tret.decode_token_cached(
                tp, TCFG, cache, self_kv, None if i == 0 else fut[:, i - 1], i - 1,
                beams=beams, n_rows=3 * beams)
            np.testing.assert_allclose(full.numpy(), ref.numpy(), rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(step.numpy(), ref.numpy(), rtol=1e-4, atol=1e-5)


def test_tokenize_items_fresh_matches_jax():
    jcfg = jrq.RqVaeConfig(**RQ_FIELDS)
    tcfg = trq.RqVaeConfig(**RQ_FIELDS)
    jp = jax.device_get(jrq.init(jax.random.PRNGKey(2), jcfg))
    tp = convert.from_numpy(jp, device="cpu")
    x = np.random.RandomState(3).randn(64, RQ_FIELDS["input_dim"]).astype(np.float32)
    want = np.asarray(jsem.tokenize_items_fresh(jax.tree.map(jnp.asarray, jp), jcfg,
                                                jnp.asarray(x)))
    got = tsem.tokenize_items_fresh(tp, tcfg, torch.from_numpy(x))
    assert got.dtype == torch.int32 and tuple(got.shape) == (64, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    assert tsem.sem_ids_dim(tcfg) == jsem.sem_ids_dim(jcfg) == 4


@pytest.mark.parametrize("bases", [K, (16, 16, 16, 20), (256, 256, 256, 256), (3, 5, 7)])
def test_pack_prefix_keys_equal_jax_as_integers(bases):
    rng = np.random.RandomState(4)
    radix = (bases,) * D if isinstance(bases, int) else bases
    for length in range(1, len(radix) + 1):
        prefix = np.stack([rng.randint(0, radix[i], 50) for i in range(length)], -1)
        prefix = prefix.astype(np.int32)
        want = np.asarray(jsem.pack_prefix(jnp.asarray(prefix), bases))
        got = tsem.pack_prefix(torch.from_numpy(prefix), bases)
        assert got.dtype == torch.int64 and want.dtype == np.uint32
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_pack_prefix_refuses_keys_beyond_int64():
    with pytest.raises(ValueError, match="beyond int64"):
        tsem.pack_prefix(torch.zeros((2, 8), dtype=torch.int32), 2 ** 8 + 1)


def test_constants_equal_jax():
    assert tschemas.FUT_SUFFIX == jschemas.FUT_SUFFIX == "_fut"
    for k, d in ((256, 4), (16, 4), (2048, 5)):
        assert temb.sem_id_padding_idx(k, d) == jemb.sem_id_padding_idx(k, d)
    table = temb.sem_id_embedder_init(torch.Generator().manual_seed(0), K, D, 8, device="cpu")
    assert torch.all(table[temb.sem_id_padding_idx(K, D):] == 0)


def test_native_available(monkeypatch):
    assert native.available()   # the batcher builds on this machine
    monkeypatch.setenv(native.DISABLE_ENV, "1")
    assert not native.available()
