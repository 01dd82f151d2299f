"""The PyTorch port's tokenizer path against the JAX package on the CPU:
RQ-VAE tokenization, dedup column, rank-chained prefix index, prefix
membership, children masks, history tokenization and the weight bridge.

Ids, keys and masks must match exactly (ids apart from counted near-ties of
the distance argmin); float outputs within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.data.schemas import SeqBatch as JSeqBatch
from rqvae_tpu.models import io as jio
from rqvae_tpu.models import rqvae as jrq
from rqvae_tpu.tokenizer import semids as jsem
from rqvae_tpu_torch.data.schemas import SeqBatch as TSeqBatch
from rqvae_tpu_torch.models import convert
from rqvae_tpu_torch.models import rqvae as trq
from rqvae_tpu_torch.tokenizer import semids as tsem

from test_torch_kernels import near_tie_rows

K = 32
JCFG = jrq.RqVaeConfig(input_dim=24, embed_dim=8, hidden_dims=(16,), codebook_size=K,
                       n_layers=3, n_cat_feats=0)
TCFG = trq.RqVaeConfig(input_dim=24, embed_dim=8, hidden_dims=(16,), codebook_size=K,
                       n_layers=3, n_cat_feats=0)


@pytest.fixture(scope="module")
def rq_params():
    """JAX init with codebooks re-drawn near the encoder's output scale, so
    that tokens spread over the codebooks instead of collapsing."""
    jp = jax.device_get(jrq.init(jax.random.PRNGKey(0), JCFG))
    rng = np.random.RandomState(1)
    for level in jp["layers"]:
        level["codebook"] = (rng.randn(K, 8) * 0.3).astype(np.float32)
    return jax.tree.map(jnp.asarray, jp), convert.from_numpy(jp, device="cpu")


def _corpus(n=400, seed=2):
    return np.random.RandomState(seed).randn(n, 24).astype(np.float32)


def test_get_semantic_ids_and_encode_and_tokenize_match_jax(rq_params):
    jp, tp = rq_params
    x = _corpus()
    want = jrq.get_semantic_ids(jp, JCFG, jnp.asarray(x))
    got = trq.get_semantic_ids(tp, TCFG, torch.from_numpy(x))
    np.testing.assert_array_equal(got.sem_ids.numpy(), np.asarray(want.sem_ids))
    for name in ("embeddings", "residuals", "quantize_loss"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    # the fused path orders distance terms as the TPU kernel does
    ids = trq.encode_and_tokenize(tp, TCFG, torch.from_numpy(x)).numpy()
    wid = np.asarray(jrq.encode_and_tokenize(jp, JCFG, jnp.asarray(x)))
    z = trq.encode(tp, TCFG, torch.from_numpy(x)).numpy()
    cbs = trq.effective_codebooks(tp, TCFG).numpy()
    differ = (ids != wid).any(axis=1)
    assert not (differ & ~near_tie_rows(z, cbs, wid)).any()
    assert len(np.unique(wid[:, 0])) > 8, "tokens should spread over the codebook"


def _index_inputs(seed=3, n=400):
    """Corpus ids with many duplicates and shared prefixes."""
    rng = np.random.RandomState(seed)
    return rng.randint(0, 5, size=(n, 3)).astype(np.int32)


@pytest.fixture(scope="module")
def indexes():
    ids = _index_inputs()
    dedup = np.asarray(jax.jit(jsem.dedup_column, static_argnums=1)(jnp.asarray(ids), K))
    cached = np.concatenate([ids, dedup[:, None]], axis=1)
    assert dedup.max() > 5, "the corpus should hold duplicate tuples"
    return cached, jsem.build_index(jnp.asarray(cached), codebook_size=K), \
        tsem.build_index(torch.from_numpy(cached), K)


def test_dedup_column_and_build_index_match_jax(indexes):
    cached, jidx, tidx = indexes
    got = tsem.dedup_column(torch.from_numpy(cached[:, :3]), K).numpy()
    np.testing.assert_array_equal(got, cached[:, 3])  # the fixture's column is JAX's
    assert tidx.bases == jidx.bases and tidx.n_distinct == jidx.n_distinct
    assert tidx.sorted_keys.dtype == torch.int64
    for level, nd in enumerate(jidx.n_distinct):
        np.testing.assert_array_equal(tidx.sorted_keys[level, :nd].numpy(),
                                      np.asarray(jidx.sorted_keys[level, :nd]).astype(np.int64))
        assert (tidx.sorted_keys[level, nd:] == tsem.SENTINEL).all()
    assert tsem.max_duplicates(tidx) == jsem.max_duplicates(jidx)


def test_exists_prefix_matches_jax(indexes):
    cached, jidx, tidx = indexes
    rng = np.random.RandomState(4)
    for length in (1, 2, 3, 4):
        members = cached[:50, :length]
        probes = np.concatenate([members, rng.randint(0, 7, size=(50, length))]).astype(np.int32)
        want = np.asarray(jsem.exists_prefix(jidx, jnp.asarray(probes)))
        got = tsem.exists_prefix(tidx, torch.from_numpy(probes)).numpy()
        np.testing.assert_array_equal(got, want)
        assert got[:50].all()


def test_children_mask_matches_jax_and_brute_force(indexes):
    cached, jidx, tidx = indexes
    rng = np.random.RandomState(5)
    empty = np.zeros((1, 0), np.int32)
    np.testing.assert_array_equal(tsem.children_mask(tidx, torch.from_numpy(empty)).numpy(),
                                  np.asarray(jsem.children_mask(jidx, jnp.asarray(empty))))
    for length in (1, 2, 3):
        prefix = np.concatenate([cached[:40, :length],
                                 rng.randint(0, 7, size=(20, length))]).astype(np.int32)
        prefix = prefix.reshape(6, 10, length)  # leading batch dims are kept
        want = np.asarray(jsem.children_mask(jidx, jnp.asarray(prefix)))
        got = tsem.children_mask(tidx, torch.from_numpy(prefix)).numpy()
        assert got.shape == (6, 10, K)
        np.testing.assert_array_equal(got, want)
        for p, m in zip(prefix.reshape(-1, length), got.reshape(-1, K)):
            hits = cached[(cached[:, :length] == p).all(axis=1)][:, length]
            expected = np.zeros(K, bool)
            expected[hits[hits < K]] = True
            np.testing.assert_array_equal(m, expected)


def test_tokenize_sequences_matches_jax(indexes):
    cached, jidx, tidx = indexes
    rng = np.random.RandomState(6)
    b, n = 5, 7
    ids = rng.randint(0, len(cached), size=(b, n)).astype(np.int32)
    mask = np.ones((b, n), bool)
    ids[0, -2:] = -1
    mask[0, -2:] = False
    ids[1, 0] = len(cached) + 5  # out of range: clamps as a JAX gather does
    fut = rng.randint(0, len(cached), size=(b, 1)).astype(np.int32)
    arrays = dict(user_ids=np.arange(b, dtype=np.int32), ids=ids, ids_fut=fut,
                  x=np.zeros((b, n, 1), np.float32), x_fut=np.zeros((b, 1, 1), np.float32),
                  seq_mask=mask)
    want = jsem.tokenize_sequences(jidx, JSeqBatch(**{k: jnp.asarray(v) for k, v in arrays.items()}))
    got = tsem.tokenize_sequences(tidx, TSeqBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()}))
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)


def test_precompute_corpus_ids_matches_jax(rq_params):
    jp, tp = rq_params
    x = _corpus()  # as many rows as the index fixture: JAX reuses its compiled ops
    jidx = jsem.precompute_corpus_ids(jp, JCFG, jnp.asarray(x), chunk_size=128)
    tidx = tsem.precompute_corpus_ids(tp, TCFG, torch.from_numpy(x), chunk_size=128)
    np.testing.assert_array_equal(tidx.cached_ids.numpy(), np.asarray(jidx.cached_ids))
    assert tidx.n_distinct == jidx.n_distinct and tidx.bases == jidx.bases


def test_load_pretrained_reads_a_jax_save_pretrained_directory(rq_params, tmp_path):
    jp, _ = rq_params
    jio.save_pretrained(str(tmp_path / "rq"), jp, JCFG)
    params, cfg = convert.load_pretrained(str(tmp_path / "rq"), device="cpu")
    assert cfg == TCFG
    np.testing.assert_array_equal(params["encoder"][1].numpy(), np.asarray(jp["encoder"][1]))
    np.testing.assert_array_equal(params["layers"][2]["codebook"].numpy(),
                                  np.asarray(jp["layers"][2]["codebook"]))
