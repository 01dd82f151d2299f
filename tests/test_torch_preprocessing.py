"""The port's raw-file preprocessors and text encoders
(``rqvae_tpu_torch.data.{amazon,movielens,text}``) against the JAX
package's, on the CPU.

The same raw fixtures (written into ``tmp_path``, from a numpy seed where
they are random) go through ``rqvae_tpu.data.amazon`` / ``movielens`` and
the port's modules: every artifact array must be equal, dtype included.
The port's ``hashed_stub_encoder`` must give JAX's bytes. The sentence-t5
pipeline runs on a tiny ``T5EncoderModel`` built locally from a config
(no download): padding and batch-size invariance, an independent
formulation of the recipe, and equality with JAX's pipeline on the same
model.
"""
import gzip
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from rqvae_tpu.data import amazon as jamazon
from rqvae_tpu.data import movielens as jml
from rqvae_tpu.data import text as jtext
from rqvae_tpu_torch.data import amazon as tamazon
from rqvae_tpu_torch.data import movielens as tml
from rqvae_tpu_torch.data import registry as treg
from rqvae_tpu_torch.data import text as ttext

REPO = pathlib.Path(__file__).resolve().parent.parent


def _assert_dirs_equal(want_dir, got_dir):
    """Every artifact file of ``want_dir`` is in ``got_dir`` with equal
    arrays (names, dtypes, shapes, values)."""
    names = sorted(os.listdir(want_dir))
    assert names == sorted(os.listdir(got_dir))
    assert names
    for name in names:
        a, b = os.path.join(want_dir, name), os.path.join(got_dir, name)
        if name.endswith(".npz"):
            with np.load(a) as za, np.load(b) as zb:
                assert sorted(za.files) == sorted(zb.files), name
                for key in za.files:
                    assert za[key].dtype == zb[key].dtype, (name, key)
                    np.testing.assert_array_equal(zb[key], za[key], err_msg=f"{name}:{key}")
        else:
            x, y = np.load(a), np.load(b)
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(y, x, err_msg=name)


# ---------------------------------------------------------------------------
# the stub encoder
# ---------------------------------------------------------------------------

TEXTS = ["", "abc", "abc", "Title: Lipstick; Brand: Unknown; Categories: ['Beauty']; Price: 9.99; ",
         "naïve café ☕", "x" * 500]


@pytest.mark.parametrize("dim,seed", [(768, 0), (16, 0), (7, 12345)])
def test_hashed_stub_encoder_bytes_equal_jax(dim, seed):
    want = jtext.hashed_stub_encoder(dim=dim, seed=seed)(TEXTS)
    got = ttext.hashed_stub_encoder(dim=dim, seed=seed)(TEXTS)
    assert got.dtype == want.dtype == np.float32 and got.shape == (len(TEXTS), dim)
    assert got.tobytes() == want.tobytes()
    np.testing.assert_array_equal(got[1], got[2])
    assert not np.allclose(got[1], got[3])


def test_stub_encoder_process_stable():
    """The same vectors whatever PYTHONHASHSEED is (sha256-seeded)."""
    code = ("from rqvae_tpu_torch.data.text import hashed_stub_encoder;"
            "print(repr(hashed_stub_encoder(dim=8)(['abc', 'xyz']).tolist()))")
    outs = set()
    for seed in ("0", "12345"):
        r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                           cwd=REPO, env={"PYTHONHASHSEED": seed, "PATH": "/usr/bin:/bin"},
                           timeout=60)
        assert r.returncode == 0, r.stderr[-500:]
        outs.add(r.stdout.strip())
    assert len(outs) == 1


# ---------------------------------------------------------------------------
# the sentence-t5 pipeline on a tiny local T5
# ---------------------------------------------------------------------------


class CharTokenizer:
    """An HF-tokenizer-shaped callable: char ids + EOS, right padding."""

    def __call__(self, texts, padding=True, truncation=True, max_length=256,
                 return_tensors="pt"):
        ids = [[(ord(c) % 60) + 2 for c in t[:max_length - 1]] + [1] for t in texts]
        width = max(len(i) for i in ids)
        input_ids = torch.zeros(len(ids), width, dtype=torch.long)
        mask = torch.zeros(len(ids), width, dtype=torch.long)
        for r, i in enumerate(ids):
            input_ids[r, :len(i)] = torch.tensor(i)
            mask[r, :len(i)] = 1
        return {"input_ids": input_ids, "attention_mask": mask}


@pytest.fixture(scope="module")
def tiny_t5():
    from transformers import T5Config, T5EncoderModel

    torch.manual_seed(0)
    cfg = T5Config(vocab_size=64, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4,
                   dropout_rate=0.0)
    return T5EncoderModel(cfg).eval()


T5_TEXTS = [
    "Title: lipstick; Brand: X; Categories: ['Beauty']; Price: 3.0;",
    "a much longer item description with many more characters in it "
    "to force real padding differences across the batch",
    "short",
    "Title: shampoo; Brand: Y; Categories: ['Beauty']; Price: 7.5;",
    "mid-length text entry",
]


def test_t5_pipeline_padding_invariance(tiny_t5):
    enc = ttext.make_t5_pipeline_encoder(CharTokenizer(), tiny_t5, batch_size=8, device="cpu")
    batched = enc(T5_TEXTS)
    for i, t in enumerate(T5_TEXTS):
        np.testing.assert_allclose(batched[i], enc([t])[0], rtol=1e-4, atol=1e-5)


def test_t5_pipeline_batch_size_invariance(tiny_t5):
    small = ttext.make_t5_pipeline_encoder(CharTokenizer(), tiny_t5, batch_size=2, device="cpu")
    big = ttext.make_t5_pipeline_encoder(CharTokenizer(), tiny_t5, batch_size=32, device="cpu")
    np.testing.assert_allclose(small(T5_TEXTS), big(T5_TEXTS), rtol=1e-4, atol=1e-5)


def test_t5_pipeline_matches_independent_recipe(tiny_t5):
    torch.manual_seed(1)
    dense_w = torch.randn(16, 32)   # (out, d_model), the 2_Dense head's shape
    got = ttext.make_t5_pipeline_encoder(CharTokenizer(), tiny_t5, dense_w, batch_size=8,
                                         device="cpu")(T5_TEXTS)
    assert got.shape == (len(T5_TEXTS), 16)
    tok = CharTokenizer()
    with torch.no_grad():
        for i, t in enumerate(T5_TEXTS):
            h = tiny_t5(**tok([t])).last_hidden_state[0]     # (T, D), no padding
            out = dense_w @ h.mean(0)
            np.testing.assert_allclose(got[i], (out / out.norm()).numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), np.ones(len(T5_TEXTS)), rtol=1e-5)


@pytest.mark.parametrize("with_dense", [False, True])
def test_t5_pipeline_equals_jax_pipeline(tiny_t5, with_dense):
    dense_w = torch.randn(16, 32, generator=torch.Generator().manual_seed(2)) if with_dense else None
    want = jtext.make_t5_pipeline_encoder(CharTokenizer(), tiny_t5, dense_w, batch_size=3)(T5_TEXTS)
    got = ttext.make_t5_pipeline_encoder(CharTokenizer(), tiny_t5, dense_w, batch_size=3,
                                         device="cpu")(T5_TEXTS)
    np.testing.assert_array_equal(got, want)


def test_t5_encoders_need_cuda_unless_cpu_requested(tiny_t5, monkeypatch):
    """No GPU and no device given: both raise before anything is loaded."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttext.make_t5_pipeline_encoder(CharTokenizer(), tiny_t5)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttext.sentence_t5_encoder()


# ---------------------------------------------------------------------------
# Amazon
# ---------------------------------------------------------------------------


def _write_amazon_raw(root, lines, metas, n_items, split="beauty"):
    raw = root / "raw" / split
    raw.mkdir(parents=True)
    (raw / "sequential_data.txt").write_text("\n".join(lines) + "\n")
    (raw / "datamaps.json").write_text(
        json.dumps({"item2id": {f"A{i}": str(i) for i in range(1, n_items + 1)}}))
    with gzip.open(raw / "meta.json.gz", "wt") as f:
        for m in metas:
            f.write(repr(m) + "\n")
    return root


def _tiny_amazon(root):
    """JAX's own fixture: 4 users, 5 items (1-based ids in the raw file)."""
    lines = ["1 1 2 3 4 5", "2 3 4 5", "3 2 1 4", "4 5 4 3 2 1"]
    metas = [{"asin": f"A{i}", "title": f"item {i}", "brand": f"b{i}",
              "categories": [["Beauty", "Hair"]], "price": float(i)} for i in range(1, 6)]
    return _write_amazon_raw(root, lines, metas, 5)


def _seeded_amazon(root, seed=3, n_items=40, n_users=30):
    """Random histories of 3 to 30 items (longer than L + 2 = 22, so the
    eval / test windows are cut), metadata with a missing or None brand, no
    categories and one item without a metadata line, and a metadata line for
    an asin outside the map."""
    rng = np.random.RandomState(seed)
    lines = []
    for u in range(1, n_users + 1):
        items = rng.randint(1, n_items + 1, rng.randint(3, 31))
        lines.append(" ".join(map(str, [u, *items])))
    metas = []
    for i in range(1, n_items + 1):
        if i == 7:
            continue
        m = {"asin": f"A{i}", "title": f"product {rng.randint(1000)}",
             "price": round(float(rng.rand() * 50), 2)}
        if i % 5:
            m["brand"] = None if i % 11 == 0 else f"brand{i % 4}"
        if i % 3:
            m["categories"] = [["Beauty", f"cat{i % 6}"]]
        metas.append(m)
    metas.append({"asin": "B_unmapped", "title": "ignored"})
    return _write_amazon_raw(root, lines, metas, n_items)


@pytest.mark.parametrize("fixture,dim", [(_tiny_amazon, 32), (_seeded_amazon, 24)],
                         ids=["tiny", "seeded"])
def test_amazon_artifacts_equal_jax(tmp_path, fixture, dim):
    fixture(tmp_path / "jax")
    shutil.copytree(tmp_path / "jax" / "raw", tmp_path / "port" / "raw")
    want = jamazon.process(str(tmp_path / "jax"), "beauty",
                           encode_fn=jtext.hashed_stub_encoder(dim=dim))
    got = tamazon.process(str(tmp_path / "port"), "beauty",
                          encode_fn=ttext.hashed_stub_encoder(dim=dim))
    assert got == str(tmp_path / "port" / "processed_beauty")
    _assert_dirs_equal(want, got)


def test_amazon_process_and_load(tmp_path):
    """Leave-last-two-out through the port's registry, and the cache."""
    root = _tiny_amazon(tmp_path)
    out = tamazon.process(str(root), "beauty", encode_fn=ttext.hashed_stub_encoder(dim=32))
    bundle = treg.load(treg.RecDataset.AMAZON, str(root), split="beauty")
    assert bundle.items.x.shape == (5, 32) and bundle.max_seq_len == 20
    tr, ev, te = bundle.train_seqs, bundle.eval_seqs, bundle.test_seqs
    # user 1: [1..5] 1-based -> [0..4]
    assert tr.item_ids_fut[0, 0] == 3 and te.item_ids_fut[0, 0] == 4
    np.testing.assert_array_equal(tr.item_ids[0][:3], [0, 1, 2])
    row = ev.item_ids[0]
    assert row[row >= 0][-1] == 2 and ev.item_ids_fut[0, 0] == 3
    row = te.item_ids[0]
    assert row[row >= 0][-1] == 3
    # a second call is a no-op; force rewrites with another encoder
    before = np.load(os.path.join(out, "items.npz"))["x"]
    assert tamazon.process(str(root), "beauty", encode_fn=ttext.hashed_stub_encoder(dim=8)) == out
    np.testing.assert_array_equal(np.load(os.path.join(out, "items.npz"))["x"], before)
    tamazon.process(str(root), "beauty", encode_fn=ttext.hashed_stub_encoder(dim=8), force=True)
    assert np.load(os.path.join(out, "items.npz"))["x"].shape == (5, 8)


def test_amazon_missing_raw_dir(tmp_path):
    with pytest.raises(FileNotFoundError, match="sequential_data.txt"):
        tamazon.process(str(tmp_path), "toys", encode_fn=ttext.hashed_stub_encoder(dim=4))


@pytest.mark.parametrize("meta", [
    {"title": "Lipstick", "brand": None, "categories": [["Beauty"]], "price": 9.99},
    {"title": "Lipstick", "brand": float("nan"), "price": 1.0},
    {"title": "Brush", "brand": "Acme", "categories": [], "price": None},
    {},
])
def test_amazon_sentence_template_equals_jax(meta):
    assert tamazon._item_sentence(meta) == jamazon._item_sentence(meta)
    if meta.get("title") == "Lipstick" and meta.get("price") == 9.99:
        assert tamazon._item_sentence(meta) == (
            "Title: Lipstick; Brand: Unknown; Categories: ['Beauty']; Price: 9.99; ")


def test_amazon_main_equals_jax_main(tmp_path, capsys):
    _seeded_amazon(tmp_path / "jax", seed=5, n_items=12, n_users=9)
    shutil.copytree(tmp_path / "jax" / "raw", tmp_path / "port" / "raw")
    jamazon.main(["--root", str(tmp_path / "jax"), "--stub-encoder", "--max-seq-len", "6"])
    tamazon.main(["--root", str(tmp_path / "port"), "--stub-encoder", "--max-seq-len", "6"])
    assert "artifacts written to" in capsys.readouterr().out
    _assert_dirs_equal(tmp_path / "jax" / "processed_beauty", tmp_path / "port" / "processed_beauty")


def test_registry_names_the_port_preprocessors(tmp_path):
    with pytest.raises(FileNotFoundError, match=r"python -m rqvae_tpu_torch\.data\.amazon"):
        treg.load(treg.RecDataset.AMAZON, str(tmp_path), split="beauty")
    with pytest.raises(FileNotFoundError, match=r"rqvae_tpu_torch\.data\.movielens"):
        treg.load(treg.RecDataset.ML_1M, str(tmp_path))


# ---------------------------------------------------------------------------
# MovieLens
# ---------------------------------------------------------------------------


def _ml1m_raw(root):
    """JAX's own fixture: 3 movies kept, 1 dropped; 5 users kept, 1 dropped."""
    raw = root / "raw"
    raw.mkdir(parents=True)
    rng = np.random.RandomState(0)
    rows, t = [], 0
    for u in range(1, 6):
        for m in [10, 20, 30, 10, 20, 30]:
            rows.append(f"{u}::{m}::{rng.randint(1, 6)}::{t}")
            t += 1
    rows.append(f"9::10::5::{t}")
    rows.append(f"1::99::5::{t + 1}")
    (raw / "ratings.dat").write_text("\n".join(rows) + "\n")
    (raw / "movies.dat").write_text("\n".join([
        "10::Toy Story (1995)::Animation|Comedy", "20::Heat (1995)::Action|Crime",
        "30::Casino (1995)::Crime|Drama", "99::Obscure (1999)::Drama"]) + "\n")
    return root


def _ml_seeded_ratings(rng, n_users, movie_ids, lo, hi):
    rows = []
    for u in range(1, n_users + 1):
        n = rng.randint(lo, hi)
        ts = np.sort(rng.randint(0, 10**6, n))
        for m, t in zip(rng.choice(movie_ids, n), ts):
            rows.append((u, int(m), float(rng.randint(1, 11)) / 2, int(t)))
    return rows


def _ml1m_seeded(root, seed=1):
    raw = root / "raw"
    raw.mkdir(parents=True)
    rng = np.random.RandomState(seed)
    genres = ["Action", "Comedy", "Drama", "Sci-Fi", "Children's"]
    movie_ids = np.arange(1, 41) * 3
    rows = _ml_seeded_ratings(rng, 25, movie_ids[:30], 2, 40)
    rows += [(99, int(movie_ids[35]), 4.0, 5)]           # a rare movie and a rare user
    (raw / "ratings.dat").write_text("\n".join("::".join(map(str, (u, m, int(r), t)))
                                               for u, m, r, t in rows) + "\n")
    (raw / "movies.dat").write_text("\n".join(
        f"{m}::Movie {m} (The) ({1990 + m % 9})::"
        + "|".join(sorted(set(rng.choice(genres, rng.randint(1, 3)))))
        for m in movie_ids) + "\n")
    return root


def _ml32m_seeded(root, seed=2):
    raw = root / "raw"
    raw.mkdir(parents=True)
    rng = np.random.RandomState(seed)
    genres = ["Action", "Comedy", "Drama", "Horror", "(no genres listed)"]
    movie_ids = np.arange(1, 31) * 7
    rows = _ml_seeded_ratings(rng, 12, movie_ids[:25], 1, 420)
    lines = ["userId,movieId,rating,timestamp"] + [f"{u},{m},{r},{t}" for u, m, r, t in rows]
    (raw / "ratings.csv").write_text("\n".join(lines) + "\n")
    movies = ["movieId,title,genres"] + [
        f'{m},"Film {m}, Part {m % 3} ({2000 + m % 20})",'
        + "|".join(sorted(set(rng.choice(genres, rng.randint(1, 4))))) for m in movie_ids]
    (raw / "movies.csv").write_text("\n".join(movies) + "\n")
    return root


@pytest.mark.parametrize("fixture,variant,max_seq_len", [
    (_ml1m_raw, "ml1m", 4), (_ml1m_seeded, "ml1m", 16), (_ml32m_seeded, "ml32m", 200)],
    ids=["ml1m-tiny", "ml1m-seeded", "ml32m-seeded"])
def test_movielens_artifacts_equal_jax(tmp_path, fixture, variant, max_seq_len):
    fixture(tmp_path / "jax")
    shutil.copytree(tmp_path / "jax" / "raw", tmp_path / "port" / "raw")
    want = jml.process(str(tmp_path / "jax"), variant, max_seq_len=max_seq_len,
                       encode_fn=jtext.hashed_stub_encoder(dim=16))
    got = tml.process(str(tmp_path / "port"), variant, max_seq_len=max_seq_len,
                      encode_fn=ttext.hashed_stub_encoder(dim=16))
    assert got == str(tmp_path / "port" / "processed")
    _assert_dirs_equal(want, got)
    with np.load(os.path.join(got, "seqs_eval.npz")) as z:
        assert len(z["user_ids"]) > 0 and (z["item_ids_fut"] >= 0).all()


def test_ml1m_process_and_load(tmp_path):
    root = _ml1m_raw(tmp_path)
    tml.process(str(root), "ml1m", max_seq_len=4, encode_fn=ttext.hashed_stub_encoder(dim=16))
    bundle = treg.load(treg.RecDataset.ML_1M, str(root))
    assert bundle.items.x.shape == (3, 16 + 5)   # movie 99 dropped; 5 genres
    tr, ev = bundle.train_seqs, bundle.eval_seqs
    assert len(tr) > 0 and len(ev) > 0 and bundle.test_seqs is None
    assert np.all(tr.item_ids_fut == -1) and np.all(ev.item_ids_fut >= 0)
    assert 9 not in set(tr.user_ids) | set(ev.user_ids)
    assert tr.item_ids.max() < 3 and tr.item_ids.min() >= -1


def test_movielens_unknown_variant(tmp_path):
    with pytest.raises(ValueError, match="unknown variant"):
        tml.process(str(tmp_path), "ml100k", encode_fn=ttext.hashed_stub_encoder(dim=4))


def test_low_occurrence_filter_and_windows_equal_jax():
    import pandas as pd

    ratings = pd.DataFrame({"userId": [1] * 5 + [2], "movieId": [7, 7, 7, 7, 7, 8],
                            "rating": [5] * 6, "timestamp": range(6)})
    assert tml._low_occurrence_filter(ratings, "movieId") == {7}
    assert tml._low_occurrence_filter(ratings, "userId", min_count=1) == {1, 2}
    # window 3, stride 2: per-user windows [0:3], [2:5], [4:5] over 5 ratings
    ratings = pd.DataFrame({"userId": [1] * 5, "movieId": [10, 20, 30, 10, 20],
                            "rating": [5] * 5, "timestamp": range(5)})
    movies = pd.Series([10, 20, 30])
    hist = tml.build_histories(ratings, movies, window=3, stride=2, train_split=1.0)
    ids = hist["train"]["item_ids"]
    np.testing.assert_array_equal(ids, [[0, 1, 2], [2, 0, 1], [1, -1, -1]])
    want = jml.build_histories(ratings, movies, window=3, stride=2, train_split=1.0)
    for sp in ("train", "eval"):
        for key in want[sp]:
            np.testing.assert_array_equal(hist[sp][key], want[sp][key])


def test_movielens_main_equals_jax_main(tmp_path):
    _ml32m_seeded(tmp_path / "jax", seed=4)
    shutil.copytree(tmp_path / "jax" / "raw", tmp_path / "port" / "raw")
    args = ["--variant", "ml32m", "--stub-encoder", "--max-seq-len", "50"]
    jml.main(["--root", str(tmp_path / "jax"), *args])
    tml.main(["--root", str(tmp_path / "port"), *args])
    _assert_dirs_equal(tmp_path / "jax" / "processed", tmp_path / "port" / "processed")


def test_preprocessors_import_no_optional_dependency():
    """pandas, transformers and huggingface_hub are imported inside the
    functions that use them: importing the modules loads none of them."""
    code = ("import sys\n"
            "import rqvae_tpu_torch.data.amazon, rqvae_tpu_torch.data.movielens\n"
            "import rqvae_tpu_torch.data.text, rqvae_tpu_torch.models.io\n"
            "import rqvae_tpu_torch.evaluate.run_eval\n"
            "bad = sorted(m for m in ('pandas', 'transformers', 'huggingface_hub')\n"
            "             if m in sys.modules)\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
