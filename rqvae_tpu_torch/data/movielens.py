"""MovieLens 1M / 32M offline preprocessing -> .npz artifacts (the port's
own copy of rqvae_tpu/data/movielens.py; both write the same arrays).

  * Low-occurrence filter: movies (and users) with fewer than 5 ratings are
    dropped from the ratings; ML-1M also drops such movies from the item
    table, ML-32M keeps every movie of ``movies.csv``.
  * Item features: the title's text up to the first "(" through
    ``encode_fn``, concatenated with the genre one-hot matrix.
  * User histories: rolling windows of ``max_seq_len`` over each user's
    time-sorted ratings (stride 1 for 1M, 180 for 32M), split by the 0.8
    quantile of each window's latest timestamp. Train rows keep the whole
    window (fut = -1, crop-subsampled at train time); eval rows hold out
    the window's last item as the target and need more than one item.
  * ``items.npz`` also gets a seeded 95/5 ``is_train`` item split.

``pandas`` is imported inside the functions that read the raw files, so the
module imports where pandas is not installed.

Run: ``python -m rqvae_tpu_torch.data.movielens --root <dir> --variant ml1m
[--stub-encoder]``.
"""
from __future__ import annotations

import os
from typing import TYPE_CHECKING, List, Optional, Tuple

import numpy as np

from rqvae_tpu_torch.data.text import EncodeFn

if TYPE_CHECKING:
    import pandas as pd


def _low_occurrence_filter(ratings: pd.DataFrame, col: str, min_count: int = 5) -> set:
    counts = ratings.groupby(col).size()
    return set(counts[counts >= min_count].index)


def load_ml1m(raw_dir: str) -> Tuple[pd.DataFrame, pd.DataFrame]:
    """(movies, ratings) of the 1M '::' format."""
    import pandas as pd

    ratings = pd.read_csv(
        os.path.join(raw_dir, "ratings.dat"), sep="::", header=None,
        names=["userId", "movieId", "rating", "timestamp"],
        encoding="ISO-8859-1", engine="python",
    )
    movies = pd.read_csv(
        os.path.join(raw_dir, "movies.dat"), sep="::", header=None,
        names=["movieId", "title", "genres"],
        encoding="ISO-8859-1", engine="python",
    )
    keep_movies = _low_occurrence_filter(ratings, "movieId")
    keep_users = _low_occurrence_filter(ratings, "userId")
    movies = movies[movies["movieId"].isin(keep_movies)].reset_index(drop=True)
    ratings = ratings[
        ratings["movieId"].isin(keep_movies) & ratings["userId"].isin(keep_users)
    ].reset_index(drop=True)
    return movies, ratings


def load_ml32m(raw_dir: str) -> Tuple[pd.DataFrame, pd.DataFrame]:
    """(movies, ratings) of the 32M csv format: every movie stays in the item
    table; the ratings drop low-occurrence users and movies."""
    import pandas as pd

    ratings = pd.read_csv(os.path.join(raw_dir, "ratings.csv"))
    movies = pd.read_csv(os.path.join(raw_dir, "movies.csv"))
    keep_movies = _low_occurrence_filter(ratings, "movieId")
    keep_users = _low_occurrence_filter(ratings, "userId")
    ratings = ratings[
        ratings["movieId"].isin(keep_movies) & ratings["userId"].isin(keep_users)
    ].reset_index(drop=True)
    return movies, ratings


def build_items(movies: pd.DataFrame, encode_fn: EncodeFn, *, seed: int = 42,
                train_frac: float = 0.95) -> dict:
    """{"x", "is_train", "genre_names"}: title embeddings beside the genre
    one-hots, and the seeded item split."""
    titles = [str(t).split("(")[0].strip() for t in movies["title"]]
    genres_onehot = movies["genres"].str.get_dummies("|")
    x = np.concatenate(
        [encode_fn(titles).astype(np.float32), genres_onehot.to_numpy().astype(np.float32)],
        axis=1,
    )
    rng = np.random.RandomState(seed)
    is_train = rng.rand(x.shape[0]) < train_frac
    return {"x": x, "is_train": is_train, "genre_names": list(genres_onehot.columns)}


def build_histories(ratings: pd.DataFrame, movie_ids: pd.Series, *, window: int = 200,
                    stride: int = 1, train_split: float = 0.8) -> dict:
    """Rolling windows and the time-quantile split: {"train", "eval"}, each
    a dict of ``user_ids``, ``item_ids`` and ``item_ids_fut``. Each user's
    windows start at 0, stride, 2 stride, ... of their own ratings."""
    movie_to_idx = {m: i for i, m in enumerate(movie_ids)}
    df = ratings.sort_values(["userId", "timestamp"], kind="stable")
    item_idx = df["movieId"].map(movie_to_idx).to_numpy()
    ts = df["timestamp"].to_numpy()
    users = df["userId"].to_numpy()

    win_user, win_items, win_maxts = [], [], []
    boundaries = np.flatnonzero(np.diff(users)) + 1
    starts = np.concatenate([[0], boundaries])
    ends = np.concatenate([boundaries, [len(users)]])
    for s, e in zip(starts, ends):
        u = users[s]
        for w0 in range(s, e, stride):
            w1 = min(w0 + window, e)
            win_user.append(u)
            win_items.append(item_idx[w0:w1])
            win_maxts.append(ts[w0:w1].max())

    win_maxts = np.asarray(win_maxts)
    threshold = np.quantile(win_maxts, train_split)
    is_train = win_maxts <= threshold
    seq_lens = np.asarray([len(w) for w in win_items])
    max_len = int(seq_lens.max())

    def pack(mask, holdout_last: bool):
        rows = np.flatnonzero(mask)
        ids = np.full((len(rows), max_len), -1, np.int32)
        fut = np.full((len(rows), 1), -1, np.int32)
        for r, i in enumerate(rows):
            w = win_items[i]
            if holdout_last:
                ids[r, :len(w) - 1] = w[:-1]
                fut[r, 0] = w[-1]
            else:
                ids[r, :len(w)] = w
        return {
            "user_ids": np.asarray([win_user[i] for i in rows], np.int32),
            "item_ids": ids,
            "item_ids_fut": fut,
        }

    eval_mask = (~is_train) & (seq_lens > 1)
    return {"train": pack(is_train, False), "eval": pack(eval_mask, True)}


def process(root: str, variant: str = "ml1m", *, max_seq_len: int = 200,
            encode_fn: Optional[EncodeFn] = None, force: bool = False) -> str:
    """The whole offline pipeline from ``<root>/raw`` to ``<root>/processed``;
    returns the artifact directory, kept as it is unless ``force``."""
    raw_dir = os.path.join(root, "raw")
    out_dir = os.path.join(root, "processed")
    items_path = os.path.join(out_dir, "items.npz")
    if os.path.exists(items_path) and not force:
        return out_dir
    if encode_fn is None:
        from rqvae_tpu_torch.data.text import sentence_t5_encoder

        encode_fn = sentence_t5_encoder()

    if variant == "ml1m":
        movies, ratings = load_ml1m(raw_dir)
        stride = 1
    elif variant == "ml32m":
        movies, ratings = load_ml32m(raw_dir)
        stride = 180
    else:
        raise ValueError(f"unknown variant: {variant}")

    os.makedirs(out_dir, exist_ok=True)
    items = build_items(movies, encode_fn)
    np.savez_compressed(items_path, x=items["x"], is_train=items["is_train"])
    hist = build_histories(ratings, movies["movieId"], window=max_seq_len, stride=stride)
    for sp, arrs in hist.items():
        np.savez_compressed(os.path.join(out_dir, f"seqs_{sp}.npz"), **arrs)
    return out_dir


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", required=True)
    p.add_argument("--variant", default="ml1m", choices=["ml1m", "ml32m"])
    p.add_argument("--max-seq-len", type=int, default=200)
    p.add_argument("--force", action="store_true")
    p.add_argument("--stub-encoder", action="store_true",
                   help="use the hashed stub encoder (no model download)")
    args = p.parse_args(argv)
    encode_fn = None
    if args.stub_encoder:
        from rqvae_tpu_torch.data.text import hashed_stub_encoder

        encode_fn = hashed_stub_encoder()
    out = process(args.root, args.variant, max_seq_len=args.max_seq_len,
                  encode_fn=encode_fn, force=args.force)
    print(f"artifacts written to {out}")


if __name__ == "__main__":
    main()
