"""The port's native crop batcher (``rqvae_tpu_torch/native``) against the
JAX package's: the tests of ``tests/test_native_batcher.py`` on the port's
copy, the crops of ``native.subsample_batch`` and ``SeqDataset.batch_at``
equal to JAX's native crops for one seed and one generator state (exactly;
JAX's ``batcher.c`` built into a temporary directory, never in place),
a failed build that raises, and ``RQVAE_TPU_DISABLE_NATIVE=1`` taking the
Python path, whose crops equal JAX's Python path."""
import contextlib
import pathlib
import shutil

import numpy as np
import pytest

from rqvae_tpu import native as jnative
from rqvae_tpu.data.dataset import SeqDataset as JSeqDataset
from rqvae_tpu_torch import native
from rqvae_tpu_torch.data.dataset import SeqDataset

JAX_SRC = pathlib.Path(jnative.__file__).resolve().parent / "batcher.c"


def _arrays():
    rng = np.random.RandomState(0)
    n, stored = 50, 30
    lengths = rng.randint(1, stored + 1, n)
    ids = np.full((n, stored), -1, np.int32)
    for i, l in enumerate(lengths):
        ids[i, :l] = rng.randint(0, 1000, l)
    return dict(user_ids=np.arange(n, dtype=np.int32), item_ids=ids,
                item_ids_fut=rng.randint(0, 1000, (n, 1)).astype(np.int32), max_seq_len=10)


@pytest.fixture
def ds():
    return SeqDataset(**_arrays())


def test_native_builds_and_runs(ds):
    ids, fut = native.subsample_batch(ds.item_ids, ds.item_ids_fut, np.arange(50),
                                      ds.max_seq_len, seed=7)
    assert ids.shape == (50, 10) and fut.shape == (50,)
    assert ids.dtype == np.int32 and fut.dtype == np.int32


def test_native_crop_invariants(ds):
    """Every crop is a window of (row ++ fut): a contiguous slice, its last
    element the target, of length in [min(3, len), max_seq_len + 1]."""
    idx = np.arange(50)
    ids, fut = native.subsample_batch(ds.item_ids, ds.item_ids_fut, idx, ds.max_seq_len, seed=123)
    for b, i in enumerate(idx):
        row = ds.item_ids[i]
        seq = row[row >= 0].tolist() + [int(ds.item_ids_fut[i, 0])]
        crop = ids[b][ids[b] >= 0].tolist() + [int(fut[b])]
        assert min(3, len(seq)) <= len(crop) <= ds.max_seq_len + 1, (b, crop, seq)
        assert any(seq[s:s + len(crop)] == crop for s in range(len(seq) - len(crop) + 1))


def test_native_distribution_reasonable(ds):
    ids, _ = native.subsample_batch(ds.item_ids, ds.item_ids_fut, np.repeat(np.arange(50), 20),
                                    ds.max_seq_len, seed=5)
    lens = (ids >= 0).sum(axis=1)
    assert lens.min() >= 1 and lens.max() <= ds.max_seq_len
    assert len(np.unique(lens)) > 3


def test_batch_at_uses_native(ds, monkeypatch):
    monkeypatch.delenv(native.DISABLE_ENV, raising=False)
    calls = []
    real = native.subsample_batch
    monkeypatch.setattr(native, "subsample_batch", lambda *a: calls.append(a[-1]) or real(*a))
    b = ds.batch_at(np.arange(8), np.random.default_rng(0))
    assert b["ids"].shape == (8, 10) and b["ids_fut"].shape == (8, 1)
    assert (b["ids"] >= -1).all() and len(calls) == 1


@contextlib.contextmanager
def _jax_source(tmp_path):
    """``native`` running the JAX package's ``batcher.c``, built into
    ``tmp_path``: JAX builds its library in place, beside its source, so the
    test never triggers that build (another test process may be running it)."""
    saved = native.SRC, native.BUILD_DIR
    native.SRC, native.BUILD_DIR = JAX_SRC, tmp_path
    native._load.cache_clear()
    try:
        yield native.subsample_batch
    finally:
        native.SRC, native.BUILD_DIR = saved
        native._load.cache_clear()


@pytest.mark.parametrize("seed", [0, 7, 2**63 - 2])
def test_native_crops_equal_jaxs(ds, seed, tmp_path):
    idx = np.random.RandomState(1).randint(0, 50, 300)
    got = native.subsample_batch(ds.item_ids, ds.item_ids_fut, idx, ds.max_seq_len, seed)
    with _jax_source(tmp_path) as jax_subsample:
        want = jax_subsample(ds.item_ids, ds.item_ids_fut, idx, ds.max_seq_len, seed)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_batch_at_equals_jaxs_native_crops_for_one_generator_state(ds, monkeypatch, tmp_path):
    monkeypatch.delenv(native.DISABLE_ENV, raising=False)
    trng, jrng = np.random.default_rng(11), np.random.default_rng(11)
    got = [ds.sample_batch(trng, 64, subsample=True) for _ in range(3)]
    jds = JSeqDataset(**_arrays())
    with _jax_source(tmp_path) as jax_subsample:
        monkeypatch.setattr(jnative, "subsample_batch", jax_subsample)
        want = [jds.sample_batch(jrng, 64, subsample=True) for _ in range(3)]
    for g, w in zip(got, want):
        for name in w:
            np.testing.assert_array_equal(g[name], w[name], err_msg=name)


def test_python_path_when_disabled_equals_jaxs(ds, monkeypatch):
    monkeypatch.setenv(native.DISABLE_ENV, "1")
    monkeypatch.setattr(native, "subsample_batch", lambda *a: pytest.fail("native path taken"))
    jds = JSeqDataset(**_arrays())
    trng, jrng = np.random.default_rng(3), np.random.default_rng(3)
    got = ds.batch_at(np.arange(8), trng)
    rows = [jds._subsample_row(jrng, jds.item_ids[i], int(jds.item_ids_fut[i, 0]))
            for i in range(8)]
    np.testing.assert_array_equal(got["ids"], np.stack([r for r, _ in rows]))
    np.testing.assert_array_equal(got["ids_fut"][:, 0], [f for _, f in rows])


def test_a_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "batcher.c"
    bad.write_text("this is not C;\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native._load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="building batcher.c failed"):
            native.subsample_batch(np.zeros((2, 3), np.int32), np.zeros(2, np.int32),
                                   np.arange(2), 4, 0)
        assert not list((tmp_path / "build").glob("*.so"))
    finally:
        native._load.cache_clear()


def test_no_compiler_raises(monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C compiler"):
        native._compiler()


def test_bad_rows_are_refused(ds):
    with pytest.raises(ValueError, match="out of range"):
        native.subsample_batch(ds.item_ids, ds.item_ids_fut, np.array([50]), 10, 0)
