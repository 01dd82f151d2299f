"""Amazon Reviews offline preprocessing -> .npz artifacts (the port's own
copy of rqvae_tpu/data/amazon.py; both write the same arrays).

Input files, under ``<root>/raw/<split>/`` (split: beauty, sports, toys):
  * ``sequential_data.txt``: one line per user, ``userId item1 item2 ...``
    with 1-based item IDs (remapped to 0-based here);
  * ``datamaps.json``: ``item2id``, asin -> 1-based id;
  * ``meta.json.gz``: per-item metadata, one python dict literal a line.

Outputs, under ``<root>/processed_<split>/``:
  * ``items.npz``: ``x`` (n_items, 768) text embeddings of each item's
    sentence, ``is_train`` a 95/5 item split from ``RandomState(42)``;
  * ``item_text.npy``: the sentences;
  * ``seqs_train.npz``: each user's whole history items[:-2] (-1 padded to
    the longest user), fut = items[-2];
  * ``seqs_eval.npz``: items[-(L+2):-2] padded to L = 20, fut = items[-2];
  * ``seqs_test.npz``: items[-(L+1):-1] padded to L = 20, fut = items[-1].

Run: ``python -m rqvae_tpu_torch.data.amazon --root <dir> --split beauty
[--stub-encoder]``.
"""
from __future__ import annotations

import ast
import gzip
import json
import os
from typing import List, Optional

import numpy as np

from rqvae_tpu_torch.data.text import EncodeFn


def _parse_meta(path: str):
    """meta.json.gz lines are python dict literals, read with
    ``ast.literal_eval`` (which executes nothing)."""
    with gzip.open(path, "rt") as f:
        for line in f:
            yield ast.literal_eval(line)


def _item_sentence(meta: dict) -> str:
    """The item's text: title, brand, first category path and price."""
    cats = meta.get("categories")
    cat0 = cats[0] if cats else "Unknown"
    brand = meta.get("brand")
    if brand is None or (isinstance(brand, float) and np.isnan(brand)):
        brand = "Unknown"
    return (
        f"Title: {meta.get('title')}; Brand: {brand}; "
        f"Categories: {cat0}; Price: {meta.get('price')}; "
    )


def _pad_rows(rows: List[List[int]], width: int) -> np.ndarray:
    out = np.full((len(rows), width), -1, np.int32)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


def read_sequences(path: str, max_seq_len: int = 20) -> dict:
    """Leave-last-two-out splits: {"train", "eval", "test"}, each a dict of
    ``user_ids``, ``item_ids`` and ``item_ids_fut``."""
    users, train_rows, train_fut = [], [], []
    eval_rows, eval_fut, test_rows, test_fut = [], [], [], []
    with open(path) as f:
        for line in f:
            parts = [int(p) for p in line.split()]
            users.append(parts[0])
            items = [i - 1 for i in parts[1:]]
            train_rows.append(items[:-2])
            train_fut.append(items[-2])
            eval_rows.append(items[-(max_seq_len + 2):-2])
            eval_fut.append(items[-2])
            test_rows.append(items[-(max_seq_len + 1):-1])
            test_fut.append(items[-1])
    user_ids = np.asarray(users, np.int32)
    max_train = max(len(r) for r in train_rows)

    def bundle(rows, fut, width):
        return {
            "user_ids": user_ids,
            "item_ids": _pad_rows(rows, width),
            "item_ids_fut": np.asarray(fut, np.int32)[:, None],
        }

    return {
        "train": bundle(train_rows, train_fut, max_train),
        "eval": bundle(eval_rows, eval_fut, max_seq_len),
        "test": bundle(test_rows, test_fut, max_seq_len),
    }


def build_items(raw_dir: str, encode_fn: EncodeFn, *, train_frac: float = 0.95,
                seed: int = 42) -> dict:
    """{"x", "is_train", "text"}: the encoded item sentences (an item with
    no metadata gets the empty sentence) and the seeded item split."""
    with open(os.path.join(raw_dir, "datamaps.json")) as f:
        maps = json.load(f)
    asin2id = {asin: int(v) - 1 for asin, v in maps["item2id"].items()}
    n_items = max(asin2id.values()) + 1

    sentences = [""] * n_items
    for meta in _parse_meta(os.path.join(raw_dir, "meta.json.gz")):
        idx = asin2id.get(meta.get("asin"))
        if idx is not None:
            sentences[idx] = _item_sentence(meta)
    x = encode_fn(sentences)
    rng = np.random.RandomState(seed)
    is_train = rng.rand(n_items) < train_frac
    return {"x": x.astype(np.float32), "is_train": is_train, "text": np.asarray(sentences)}


def process(root: str, split: str = "beauty", *, max_seq_len: int = 20,
            encode_fn: Optional[EncodeFn] = None, force: bool = False) -> str:
    """The whole offline pipeline; returns the artifact directory. A
    directory that already holds ``items.npz`` is kept unless ``force``."""
    raw_dir = os.path.join(root, "raw", split)
    out_dir = os.path.join(root, f"processed_{split}")
    items_path = os.path.join(out_dir, "items.npz")
    if os.path.exists(items_path) and not force:
        return out_dir
    if not os.path.isdir(raw_dir):
        raise FileNotFoundError(
            f"Expected raw Amazon data at {raw_dir} "
            "(sequential_data.txt, datamaps.json, meta.json.gz)"
        )
    if encode_fn is None:
        from rqvae_tpu_torch.data.text import sentence_t5_encoder

        encode_fn = sentence_t5_encoder()

    os.makedirs(out_dir, exist_ok=True)
    items = build_items(raw_dir, encode_fn)
    np.savez_compressed(items_path, x=items["x"], is_train=items["is_train"])
    np.save(os.path.join(out_dir, "item_text.npy"), items["text"])
    seqs = read_sequences(os.path.join(raw_dir, "sequential_data.txt"), max_seq_len)
    for sp, arrs in seqs.items():
        np.savez_compressed(os.path.join(out_dir, f"seqs_{sp}.npz"), **arrs)
    return out_dir


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", required=True)
    p.add_argument("--split", default="beauty", choices=["beauty", "sports", "toys"])
    p.add_argument("--max-seq-len", type=int, default=20)
    p.add_argument("--force", action="store_true")
    p.add_argument("--stub-encoder", action="store_true",
                   help="use the hashed stub encoder (no model download)")
    args = p.parse_args(argv)
    encode_fn = None
    if args.stub_encoder:
        from rqvae_tpu_torch.data.text import hashed_stub_encoder

        encode_fn = hashed_stub_encoder()
    out = process(args.root, args.split, max_seq_len=args.max_seq_len,
                  encode_fn=encode_fn, force=args.force)
    print(f"artifacts written to {out}")


if __name__ == "__main__":
    main()
