"""The traffic generators every mix file drives: synthetic corpora and user
histories of the public datasets' shapes, drawn from a seed. The shapes
are the repository's fixtures', copied here so that the yardstick does not
move with them (``chip_smoke.py``: ``_ml_histories``, ``_write_beauty_raw``);
the training crops are the port's own sampler's (``SeqDataset.sample_batch``).

A mix file (``traffic/<mix>.json``) names its history distribution under
``history.dist``; ``histories`` dispatches on it. Every function takes a
``numpy.random.Generator`` and returns plain numpy arrays.
"""
from __future__ import annotations

import numpy as np


def popularity(rng: np.random.Generator, n_items: int, law: dict) -> np.ndarray:
    """Item probabilities: ``{"zipf": a}`` (1 / rank^a, ranks shuffled) or
    ``{"lognormal": sigma}``."""
    if "zipf" in law:
        p = 1.0 / np.arange(1, n_items + 1) ** float(law["zipf"])
        p = p[rng.permutation(n_items)]
    else:
        p = rng.lognormal(0.0, float(law["lognormal"]), n_items)
    return p / p.sum()


def movielens_lengths(rng: np.random.Generator, users: int, ratings: int, median: float,
                      sigma: float, least: int) -> np.ndarray:
    """Ratings a user: at least ``least``, the rest log-normal, scaled to
    ``ratings`` in all (the MovieLens fixture's law)."""
    raw = rng.lognormal(np.log(median), sigma, users)
    return least + np.floor(raw / raw.sum() * (ratings - least * users)).astype(np.int64)


def rolling_windows(lengths: np.ndarray, window: int, stride: int) -> np.ndarray:
    """The lengths of the windows the MovieLens preprocessing cuts from
    each user's history: starts 0, stride, 2 stride, ... before its end."""
    out = []
    for n in lengths:
        starts = np.arange(0, n, stride)
        out.append(np.minimum(window, n - starts))
    return np.concatenate(out)


def beauty_lengths(rng: np.random.Generator, users: int, mean: float, least: int) -> np.ndarray:
    """5-core history lengths: ``least - 1`` plus a geometric count of mean
    ``mean - least + 1`` (the Amazon Beauty fixture's law)."""
    return (least - 1) + rng.geometric(1.0 / (mean - least + 1), users)


def histories(rng: np.random.Generator, mix: dict, n_items: int):
    """(item_ids (rows, width) int32 -1 padded, targets (rows, 1) int32,
    user ids (rows,) int32) for the mix's ``history`` block."""
    h = mix["history"]
    if h["dist"] == "movielens_windows":
        users = movielens_lengths(rng, int(h["users"]), int(h["ratings"]), float(h["median"]),
                                  float(h["sigma"]), int(h["least"]))
        lengths = rolling_windows(users, int(h["window"]), int(h["stride"]))
        owner = np.repeat(np.arange(len(users)), [len(range(0, n, int(h["stride"]))) for n in users])
    elif h["dist"] == "beauty_5core":
        lengths = beauty_lengths(rng, int(h["users"]), float(h["mean"]), int(h["least"]))
        owner = np.arange(len(lengths))
    else:
        raise ValueError(f"unknown history distribution {h['dist']!r}")
    p = popularity(rng, n_items, h["items"])
    width = int(lengths.max())
    flat = rng.choice(n_items, int(lengths.sum()) + len(lengths), p=p).astype(np.int32)
    ids = np.full((len(lengths), width), -1, np.int32)
    col = np.arange(width)[None, :]
    ids[col < lengths[:, None]] = flat[:int(lengths.sum())]
    fut = flat[int(lengths.sum()):].reshape(-1, 1)
    return ids, fut, owner.astype(np.int32)


def corpus_tuples(rng: np.random.Generator, n_items: int, levels: int, codebook: int) -> np.ndarray:
    """(n_items, levels) semantic-ID codes drawn uniformly, for cells that
    train the decoder on a fixed corpus table."""
    return rng.integers(0, codebook, (n_items, levels)).astype(np.int64)


def dedup_column(codes: np.ndarray) -> np.ndarray:
    """Occurrence rank of each row's tuple among the rows before it."""
    n = codes.shape[0]
    _, inverse = np.unique(codes, axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)
    order = np.lexsort((np.arange(n), inverse))
    first = np.ones(n, bool)
    first[1:] = inverse[order][1:] != inverse[order][:-1]
    pos = np.arange(n)
    start = np.maximum.accumulate(np.where(first, pos, 0))
    out = np.empty(n, np.int64)
    out[order] = pos - start
    return out
