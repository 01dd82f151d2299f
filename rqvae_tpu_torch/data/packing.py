"""Sequence packing for long-context decoder training (counterpart of
rqvae_tpu/data/packing.py).

The flat ML-32M step pads every history to ``max_seq_len`` items (801
encoder tokens), while the reference's random crop keeps ~68 items on
average: about two thirds of its tokens are padding. Packing places several
sampled crops ("segments") in one fixed-shape row of ``capacity`` items and
``slots`` segments, and the model makes attention segment-local through
per-query key spans (``ops/attention.span_mask``,
``ops/flash_attention.flash_attention_spans``). Each valid slot is exactly
one flat-step example (the same tokens, per-segment positions and
per-example loss); a step's loss is the mean over the slots it packed.

``pack_crops`` is JAX's best-fit-decreasing placement, array for array, with
one difference: JAX never places a crop longer than the capacity and carries
it forever (a known quirk of the reference); here such a crop raises. The
random crops never exceed ``max_seq_len`` items, the capacity, so the main
path never meets one.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np

from rqvae_tpu_torch.data.dataset import to_device  # noqa: F401  (what make_packed_step takes)


class PackedSeqBatch(NamedTuple):
    """A packed batch in raw item-ID space: R rows, up to S segments each,
    as numpy arrays (``to_device`` makes tensors of them). Segments occupy
    contiguous item ranges; unused slots have slot_len 0, slot_valid False
    and ids_fut -1."""

    user_ids: np.ndarray    # (R, S) int32 per-slot user (0 at unused slots)
    ids: np.ndarray         # (R, N) int32 packed item ids, -1 padding
    ids_fut: np.ndarray     # (R, S) int32 per-slot target item, -1 unused
    seg_item: np.ndarray    # (R, N) int32 slot index of each item position, -1 pad
    slot_start: np.ndarray  # (R, S) int32 item index where the slot begins
    slot_len: np.ndarray    # (R, S) int32 items in the slot (0 = unused)
    slot_valid: np.ndarray  # (R, S) bool


Crop = Tuple[int, np.ndarray, int]  # (user_id, item_ids, fut_id)


def pack_crops(crops: Sequence[Crop], rows: int, slots: int,
               capacity: int) -> Tuple[PackedSeqBatch, List[Crop]]:
    """Best-fit-decreasing packing of ``crops`` into a fixed (rows, slots,
    capacity) grid: row by row, each slot takes the longest pending crop
    that fits the row's remaining capacity. Returns (batch, leftovers), the
    crops that did not fit, in their original order. A crop longer than
    ``capacity`` raises (it could never be placed)."""
    too_long = [len(c[1]) for c in crops if len(c[1]) > capacity]
    if too_long:
        raise ValueError(f"{len(too_long)} crops longer than the capacity of {capacity} items "
                         f"(longest {max(too_long)}): they could never be packed")
    n, s = capacity, slots
    user_ids = np.zeros((rows, s), np.int32)
    ids = np.full((rows, n), -1, np.int32)
    ids_fut = np.full((rows, s), -1, np.int32)
    seg_item = np.full((rows, n), -1, np.int32)
    slot_start = np.zeros((rows, s), np.int32)
    slot_len = np.zeros((rows, s), np.int32)
    slot_valid = np.zeros((rows, s), bool)

    # pending crops sorted ascending by length; best fit = longest <= cap
    order = sorted(range(len(crops)), key=lambda i: len(crops[i][1]))
    lengths = [len(crops[i][1]) for i in order]
    taken = [False] * len(crops)

    for r in range(rows):
        cursor = 0
        for slot in range(s):
            cap = n - cursor
            if cap <= 0 or not order:
                break
            j = bisect.bisect_right(lengths, cap) - 1
            if j < 0:
                break  # nothing fits the remaining capacity
            ci = order.pop(j)
            lengths.pop(j)
            taken[ci] = True
            user, crop_ids, fut = crops[ci]
            ln = len(crop_ids)
            ids[r, cursor:cursor + ln] = crop_ids
            seg_item[r, cursor:cursor + ln] = slot
            user_ids[r, slot] = user
            ids_fut[r, slot] = fut
            slot_start[r, slot] = cursor
            slot_len[r, slot] = ln
            slot_valid[r, slot] = True
            cursor += ln

    leftovers = [c for i, c in enumerate(crops) if not taken[i]]
    batch = PackedSeqBatch(user_ids=user_ids, ids=ids, ids_fut=ids_fut, seg_item=seg_item,
                           slot_start=slot_start, slot_len=slot_len, slot_valid=slot_valid)
    return batch, leftovers


@dataclasses.dataclass
class SequencePacker:
    """Streaming packer over a ``SeqDataset``'s sampled crops.

    Each ``next_batch`` samples fresh crops (the flat step's random-crop
    subsample), tops up a carry buffer and packs a fixed (rows, slots) batch
    of ``seqs.max_seq_len`` items a row. Unplaced crops carry over, so every
    sampled crop trains exactly once (but for the buffer left at the end of
    a finite run)."""

    seqs: "object"               # data.dataset.SeqDataset
    rng: np.random.Generator
    rows: int
    slots: int
    subsample: bool = True
    _pending: List[Crop] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self.capacity = self.seqs.max_seq_len
        # sampling chunk ~ the examples a batch packs (a crop keeps ~len / 3
        # items; 40 is a conservative mean), so the buffer floats around one
        # to two chunks and best fit has material for the row tails
        self.chunk = max(32, int(self.rows * self.capacity / 40))

    def _sample_crops(self, count: int) -> List[Crop]:
        raw = self.seqs.sample_batch(self.rng, count, subsample=self.subsample)
        return [(int(u), row[row >= 0], int(fut[0]))
                for u, row, fut in zip(raw["user_ids"], raw["ids"], raw["ids_fut"])]

    def next_batch(self) -> Tuple[PackedSeqBatch, int]:
        """(packed batch, number of examples = valid slots)."""
        target = max(self.chunk, 2 * self.rows)
        if len(self._pending) < target:
            self._pending.extend(self._sample_crops(target - len(self._pending) + self.chunk))
        batch, leftovers = pack_crops(self._pending, self.rows, self.slots, self.capacity)
        self._pending = leftovers
        return batch, int(batch.slot_valid.sum())
