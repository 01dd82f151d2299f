"""Parity of the PyTorch port's decoder, beam search and metrics with the JAX
package, on the CPU at a small size.

Parameters come from ``rqvae_tpu`` inits (seeded), cross to the port as
numpy through ``rqvae_tpu_torch.models.convert``; inputs are numpy-seeded.
Everything runs in fp32 on both sides. Tolerances: 1e-4 absolute on losses,
logits and log-probas (fp32 sums taken in different orders over a few
layers); exact equality on token ids where the scores have no ties.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.data.schemas import TokenizedSeqBatch as JBatch
from rqvae_tpu.evaluate import metrics as jmetrics
from rqvae_tpu.models import generation as jgen
from rqvae_tpu.models import retrieval as jret
from rqvae_tpu.ops import attention as jattn
from rqvae_tpu.tokenizer import semids as jsem
from rqvae_tpu_torch.data.schemas import TokenizedSeqBatch as TBatch
from rqvae_tpu_torch.evaluate import metrics as tmetrics
from rqvae_tpu_torch.models import convert
from rqvae_tpu_torch.models import generation as tgen
from rqvae_tpu_torch.models import retrieval as tret
from rqvae_tpu_torch.ops import attention as tattn
from rqvae_tpu_torch.tokenizer import semids as tsem

ATOL = 1e-4
K = 32
JCFG = jret.RetrievalConfig(
    embedding_dim=16, attn_dim=64, dropout=0.0, num_heads=4, n_layers=4,
    num_embeddings=K, sem_id_dim=4, max_pos=20, input_dropout=0.0, mlp_hidden_dim=64,
)
TCFG = tret.RetrievalConfig(**{f: getattr(JCFG, f) for f in JCFG.__dataclass_fields__})


@pytest.fixture(scope="module")
def params():
    jp = jax.jit(lambda key: jret.init(key, JCFG))(jax.random.PRNGKey(0))
    return jp, convert.from_numpy(jax.device_get(jp), device="cpu")


@pytest.fixture(scope="module")
def indexes():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 8, size=(200, 3)).astype(np.int32)
    dedup = np.asarray(jax.jit(jsem.dedup_column, static_argnums=1)(jnp.asarray(ids), K))
    cached = np.concatenate([ids, dedup[:, None]], axis=1).astype(np.int32)
    return (jsem.build_index(jnp.asarray(cached), codebook_size=K),
            tsem.build_index(torch.from_numpy(cached), K))


def _batches(b=4, n_items=5, d=4, seed=1, with_fut=False):
    rng = np.random.RandomState(seed)
    n = n_items * d
    arrays = dict(
        user_ids=np.arange(b, dtype=np.int32) * 977 - 3,
        sem_ids=rng.randint(0, 8, size=(b, n)).astype(np.int32),
        seq_mask=np.ones((b, n), dtype=bool),
        token_type_ids=np.tile(np.arange(d, dtype=np.int32), (b, n_items)),
    )
    arrays["seq_mask"][0, -d:] = False       # a padded history tail
    arrays["sem_ids"][0, -d:] = -1
    fut = rng.randint(0, 8, size=(b, d)).astype(np.int32) if with_fut else None
    tt_fut = np.tile(np.arange(d, dtype=np.int32), (b, 1)) if with_fut else None
    jb = JBatch(**{k: jnp.asarray(v) for k, v in arrays.items()},
                sem_ids_fut=None if fut is None else jnp.asarray(fut),
                token_type_ids_fut=None if tt_fut is None else jnp.asarray(tt_fut))
    tb = TBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()},
                sem_ids_fut=None if fut is None else torch.from_numpy(fut),
                token_type_ids_fut=None if tt_fut is None else torch.from_numpy(tt_fut))
    return jb, tb


def _np(t):
    return t.detach().cpu().numpy()


def test_sdpa_matches_jax_including_fully_masked_rows():
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(2, 5, 3, 8).astype(np.float32) for _ in range(3))
    k_mask = np.ones((2, 5), bool)
    k_mask[1] = False  # row 1 sees no key: zeros, not NaN
    for causal in (False, True):
        want = jattn.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal, k_mask=jnp.asarray(k_mask))
        got = tattn.attend(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           causal=causal, k_mask=torch.from_numpy(k_mask))
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6)
        assert np.all(_np(got)[1] == 0.0)


def test_forward_loss_matches_jax(params):
    jp, tp = params
    jb, tb = _batches(with_fut=True)
    want = jax.jit(lambda p_, b_: jret.forward(p_, JCFG, b_))(jp, jb)
    got = tret.forward(tp, TCFG, tb)
    np.testing.assert_allclose(float(got.loss), float(want.loss), atol=ATOL)
    np.testing.assert_allclose(_np(got.logits), np.asarray(want.logits), atol=ATOL)
    np.testing.assert_allclose(_np(got.loss_d), np.asarray(want.loss_d), atol=ATOL)


def test_decode_token_cached_matches_forward_generate_cached(params):
    """The KV-cached single-token decode equals the full-prefix decode, and
    both equal JAX's, at every beam step."""
    jp, tp = params
    jb, tb = _batches()
    beams = 3
    jcache = jax.jit(lambda p_, b_: jret.encode_for_generation(p_, JCFG, b_))(jp, jb)
    jfull = jax.jit(lambda p_, c_, f_, t_: jret.forward_generate_cached(
        p_, JCFG, c_, f_, t_, beams=beams, n_rows=4 * beams))
    tcache = tret.encode_for_generation(tp, TCFG, tb)
    for (jk, jv), (tk, tv) in zip(jcache.kv, tcache.kv):
        np.testing.assert_allclose(_np(tk), np.asarray(jk), atol=ATOL)
        np.testing.assert_allclose(_np(tv), np.asarray(jv), atol=ATOL)
    rng = np.random.RandomState(4)
    fut = rng.randint(0, K, size=(4 * beams, 3)).astype(np.int32)
    tfut = torch.from_numpy(fut)
    logits, kv = tret.decode_token_cached(tp, TCFG, tcache, None, None, 0, beams=1, n_rows=4)
    kv = tuple(tuple(c.repeat_interleave(beams, dim=0) for c in layer) for layer in kv)
    for i in range(1, 4):
        logits, kv = tret.decode_token_cached(tp, TCFG, tcache, kv, tfut[:, i - 1], i - 1,
                                              beams=beams, n_rows=4 * beams)
        tt = torch.arange(i, dtype=torch.int32).repeat(4 * beams, 1)
        full = tret.forward_generate_cached(tp, TCFG, tcache, tfut[:, :i], tt,
                                            beams=beams, n_rows=4 * beams)
        want = jfull(jp, jcache, jnp.asarray(fut[:, :i]), jnp.asarray(_np(tt)))
        np.testing.assert_allclose(_np(logits), _np(full), atol=ATOL)
        np.testing.assert_allclose(_np(full), np.asarray(want), atol=ATOL)


def _check_generation(jout, tout):
    jids, jlp = np.asarray(jout.sem_ids), np.asarray(jout.log_probas)
    tids, tlp = _np(tout.sem_ids), _np(tout.log_probas)
    assert tids.shape == jids.shape and tlp.shape == jlp.shape
    # these inputs give k valid beams per row with distinct scores (gap
    # checked), so top-k order is defined and ids must agree exactly
    assert (jlp > jgen.INVALID_PENALTY / 2).all()
    assert (np.diff(-jlp, axis=-1) > 10 * ATOL).all()
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_allclose(tlp, jlp, atol=ATOL)


def test_generate_exhaustive_matches_jax(params, indexes):
    jp, tp = params
    jidx, tidx = indexes
    jb, tb = _batches()
    jout = jax.jit(lambda p_, b_: jgen.generate_next_sem_ids(
        p_, JCFG, jidx, b_, jax.random.PRNGKey(2), k=8, n_candidates=K))(jp, jb)
    tout = tgen.generate_next_sem_ids(tp, TCFG, tidx, tb, k=8, n_candidates=K)
    _check_generation(jout, tout)
    assert tsem.exists_prefix(tidx, tout.sem_ids).all()


def test_generate_sampled_matches_jax_with_injected_noise(params, indexes, monkeypatch):
    """Both frameworks draw their Gumbel uniforms from the same numpy arrays."""
    jp, tp = params
    jidx, tidx = indexes
    jb, tb = _batches()
    b, k, n_cand = 4, 8, 20
    rng = np.random.RandomState(5)
    noise = [rng.rand(b, K).astype(np.float32)] + [
        rng.rand(b * k, K).astype(np.float32) for _ in range(3)]
    queue = list(noise)

    def fake_uniform(key, shape, *args, **kwargs):
        u = queue.pop(0)
        assert u.shape == tuple(shape)
        return jnp.asarray(u)

    monkeypatch.setattr(jax.random, "uniform", fake_uniform)
    jout = jax.jit(lambda p_, b_: jgen.generate_next_sem_ids(
        p_, JCFG, jidx, b_, jax.random.PRNGKey(2), k=k, n_candidates=n_cand))(jp, jb)
    monkeypatch.undo()
    assert not queue
    tout = tgen.generate_next_sem_ids(tp, TCFG, tidx, tb, k=k, n_candidates=n_cand,
                                      uniforms=[torch.from_numpy(u) for u in noise])
    _check_generation(jout, tout)


@pytest.mark.parametrize("n", [5, 28])  # both threshold branches (top-n / bottom-(K-n+1))
def test_gumbel_topk_mask_matches_jax(n, monkeypatch):
    rng = np.random.RandomState(6)
    logp = rng.randn(6, K).astype(np.float32)
    u = rng.rand(6, K).astype(np.float32)
    monkeypatch.setattr(jax.random, "uniform", lambda *a, **kw: jnp.asarray(u))
    want = np.asarray(jgen._gumbel_topk_mask(jax.random.PRNGKey(0), jnp.asarray(logp), n))
    got = _np(tgen._gumbel_topk_mask(torch.from_numpy(logp), n, torch.from_numpy(u)))
    np.testing.assert_array_equal(got, want)
    assert (got.sum(-1) == n).all()


def test_batch_hit_counts_matches_jax():
    rng = np.random.RandomState(7)
    actual = rng.randint(0, 3, size=(16, 4)).astype(np.int32)
    top_k = rng.randint(0, 3, size=(16, 10, 4)).astype(np.int32)
    top_k[:4, 2] = actual[:4]  # some exact hits at rank 2
    valid = np.ones(16, bool)
    valid[-3:] = False
    want = jmetrics.batch_hit_counts(jnp.asarray(actual), jnp.asarray(top_k), (1, 5, 10),
                                     jnp.asarray(valid))
    got = tmetrics.batch_hit_counts(torch.from_numpy(actual), torch.from_numpy(top_k),
                                    (1, 5, 10), torch.from_numpy(valid))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), atol=1e-6, err_msg=key)
    acc = tmetrics.TopKAccumulator((1, 5))
    acc.accumulate(torch.from_numpy(actual), torch.from_numpy(top_k))
    jacc = jmetrics.TopKAccumulator((1, 5))
    jacc.accumulate(actual, top_k)
    assert acc.reduce() == pytest.approx(jacc.reduce())
