"""Semantic-ID tokenizer: corpus precompute, dedup column, prefix membership,
and the cached-ID gathers of flat and packed batches (counterpart of
rqvae_tpu/tokenizer/semids.py).

Same rank-chained index as the JAX package: the level-l key of a corpus row
is ``rank_{l-1}(prefix[:-1]) * base_l + token_l``, where the rank indexes
the previous level's distinct sorted key table, so keys stay below
``n_items * max(bases)`` at any depth or codebook size.

Keys are int64 here (torch has no sort / searchsorted for uint32) and the
padding sentinel is ``torch.iinfo(torch.int64).max``, so the index requires
``n_items * max(bases) < 2**63``. The JAX package keys in uint32 (uint64
under x64); keys compare by value, so both give the same tables and masks.

Where JAX relies on a gather clamping an out-of-range index, the port clamps
explicitly (torch raises on CPU and asserts on the device).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from rqvae_tpu_torch.data.schemas import SeqBatch, TokenizedSeqBatch
from rqvae_tpu_torch.models import rqvae as rqvae_lib
from rqvae_tpu_torch.ops import dispatch
from rqvae_tpu_torch.ops.children_window import children_window_mask, fold_tokens

KEY_DTYPE = torch.int64
SENTINEL = torch.iinfo(KEY_DTYPE).max


class CorpusIndex:
    """Corpus semantic-ID table + sorted distinct prefix keys per length.

    ``sorted_keys[l]`` holds the distinct keys of length-(l+1) prefixes,
    pushed left and padded to n_items with ``SENTINEL``; ``n_distinct[l]``
    is the real count. ``bases`` are the per-dim radices: codebook_size for
    the ID levels, ``max(codebook_size, max_dedup + 2)`` for the dedup column.
    """

    def __init__(self, cached_ids: torch.Tensor, sorted_keys: torch.Tensor,
                 bases: tuple, codebook_size: int, n_distinct: tuple):
        self.cached_ids = cached_ids      # (n_items, D) int32
        self.sorted_keys = sorted_keys    # (D, n_items) int64
        self.bases = tuple(int(b) for b in bases)
        self.codebook_size = int(codebook_size)
        self.n_distinct = tuple(int(n) for n in n_distinct)

    @property
    def n_items(self) -> int:
        return self.cached_ids.shape[0]


def sem_ids_dim(cfg: rqvae_lib.RqVaeConfig) -> int:
    """Tokens an item takes: the RQ-VAE's levels plus the dedup column."""
    return cfg.n_layers + 1


def pack_prefix(prefix: torch.Tensor, bases) -> torch.Tensor:
    """Mixed-radix Horner packing of the last axis into one int64 key (JAX's
    ``pack_prefix``, whose keys are uint32, uint64 under x64: the same
    integers). ``bases`` is one int (a uniform radix) or a radix a dim, of
    which the first ``prefix.shape[-1]`` are read. Raises ``ValueError``
    when the radices need more than int64's 63 value bits."""
    dim = prefix.shape[-1]
    if isinstance(bases, int):
        bases = (bases,) * dim
    bases = tuple(int(b) for b in bases)[:dim]
    bits = sum(max(1, math.ceil(math.log2(b))) for b in bases)
    if bits > 63:
        raise ValueError(f"prefix keys need {bits} bits for bases {bases}: beyond int64")
    key = torch.zeros(prefix.shape[:-1], dtype=KEY_DTYPE, device=prefix.device)
    for i in range(dim):
        key = key * bases[i] + prefix[..., i].to(KEY_DTYPE)
    return key


def tokenize_items_fresh(params, cfg: rqvae_lib.RqVaeConfig, x: torch.Tensor) -> torch.Tensor:
    """The fresh-encode path (no corpus cache): raw item features (B, D_in)
    to their ``n_layers``-tuple ids (B, L) int32, through
    ``rqvae.encode_and_tokenize`` (``rq_tokenize`` on the GPU)."""
    return rqvae_lib.encode_and_tokenize(params, cfg, x)


def _check_key_range(n_items: int, bases) -> None:
    span = n_items * max(int(b) for b in bases)
    if span >= 2**63 - 1:  # strict: the dtype max is the padding sentinel
        raise ValueError(f"rank-chained keys need {span} values for n_items={n_items}, "
                         f"bases {tuple(bases)}: beyond int64")


def dedup_column(sem_ids: torch.Tensor, codebook_size: int = 0) -> torch.Tensor:
    """Occurrence rank of each row's tuple in corpus order: row i gets the
    number of rows j < i with an identical tuple. ``codebook_size`` is kept
    for API compatibility and unused.

    jnp.lexsort becomes successive stable argsorts, least significant column
    first; starting from corpus order makes the position the final tie-break.
    No packed key, so any codebook size and depth works."""
    n, d = sem_ids.shape
    arange = torch.arange(n, device=sem_ids.device)
    order = arange
    for i in range(d - 1, -1, -1):
        order = order[torch.argsort(sem_ids[order, i], stable=True)]
    s = sem_ids[order]
    first = torch.ones(n, dtype=torch.bool, device=sem_ids.device)
    if n > 1:
        first[1:] = torch.any(s[1:] != s[:-1], dim=1)
    start = torch.cummax(torch.where(first, arange, 0), dim=0).values
    out = torch.empty(n, dtype=torch.int32, device=sem_ids.device)
    out[order] = (arange - start).to(torch.int32)
    return out


def precompute_corpus_ids(params, cfg: rqvae_lib.RqVaeConfig, corpus_x: torch.Tensor, *,
                          chunk_size: int = 4096) -> CorpusIndex:
    """Tokenize the corpus in ``chunk_size``-row chunks with the frozen RQ-VAE
    (one ``rq_tokenize`` launch per chunk), append the dedup column and build
    the prefix index."""
    with torch.no_grad():
        sem_ids = torch.cat([
            rqvae_lib.encode_and_tokenize(params, cfg, corpus_x[i:i + chunk_size])
            for i in range(0, corpus_x.shape[0], chunk_size)
        ], dim=0)
    dedup = dedup_column(sem_ids, cfg.codebook_size)
    cached = torch.cat([sem_ids, dedup[:, None]], dim=-1)
    return build_index(cached, cfg.codebook_size)


def build_index(cached_ids: torch.Tensor, codebook_size: int) -> CorpusIndex:
    """Rank-chained sorted distinct-key tables for every prefix length 1..D."""
    n, d = cached_ids.shape
    max_dedup = int(cached_ids[:, -1].max())
    bases = (codebook_size,) * (d - 1) + (max(codebook_size, max_dedup + 2),)
    _check_key_range(n, bases)
    dev = cached_ids.device
    rows, n_distinct = [], []
    rank = torch.zeros(n, dtype=KEY_DTYPE, device=dev)
    for level in range(d):
        keys = rank * bases[level] + cached_ids[:, level].to(KEY_DTYPE)
        skeys = torch.sort(keys).values
        first = torch.ones(n, dtype=torch.bool, device=dev)
        if n > 1:
            first[1:] = skeys[1:] != skeys[:-1]
        uniq = torch.where(first, skeys, SENTINEL)
        # firsts first, in sorted order (argsort of a bool needs an int key)
        order = torch.argsort((~first).to(torch.int8), stable=True)
        table = uniq[order]
        rows.append(table)
        n_distinct.append(int(first.sum()))
        rank = torch.searchsorted(table, keys)
    return CorpusIndex(cached_ids, torch.stack(rows, dim=0), bases, codebook_size,
                       tuple(n_distinct))


def exists_prefix(index: CorpusIndex, prefix: torch.Tensor) -> torch.Tensor:
    """Membership of ID-prefixes (..., L), 1 <= L <= D, in the corpus -> bool (...)."""
    length = prefix.shape[-1]
    _, ok = _prefix_rank(index, prefix.reshape(math.prod(prefix.shape[:-1]), length))
    return ok.reshape(prefix.shape[:-1])


def _prefix_rank(index: CorpusIndex, flat_prefix: torch.Tensor):
    """(rank, ok) of each length-L prefix row in level L-1's distinct table."""
    length = flat_prefix.shape[-1]
    dev = flat_prefix.device
    rank = torch.zeros(flat_prefix.shape[0], dtype=KEY_DTYPE, device=dev)
    ok = torch.ones(flat_prefix.shape[0], dtype=torch.bool, device=dev)
    for i in range(length):
        key = rank * index.bases[i] + flat_prefix[:, i].to(KEY_DTYPE)
        table = index.sorted_keys[i]
        pos = torch.searchsorted(table, key).clamp(0, table.shape[0] - 1)
        ok &= (table[pos] == key) & (pos < index.n_distinct[i])
        rank = pos
    return rank, ok


def children_window_inputs(index: CorpusIndex, prefix: torch.Tensor):
    """The children-window operands for a (R, L) prefix batch:
    (table, lo int32, cnt int32, key0 int64), each per row but the table."""
    length = prefix.shape[-1]
    table = index.sorted_keys[length]
    radix = index.bases[length]
    rank, ok = _prefix_rank(index, prefix)
    key0 = rank * radix
    lo = torch.searchsorted(table, key0)
    # upper bound from the run's largest possible key: rank+1 keys belong to
    # the next parent; rank*radix + radix-1 < n_distinct*radix, no overflow
    hi = torch.searchsorted(table, key0 + (radix - 1), side="right")
    hi = torch.clamp(hi, max=index.n_distinct[length])
    hi = torch.where(ok, hi, lo)
    cnt = torch.clamp(hi - lo, min=0)
    return table, lo.to(torch.int32), cnt.to(torch.int32), key0


def children_mask(index: CorpusIndex, prefix: torch.Tensor) -> torch.Tensor:
    """Valid-next-token mask for every prefix: (..., L) int -> (..., K) bool.

    Beam prefixes are valid and the level's table holds distinct sorted keys,
    so a prefix's children form one contiguous run: binary-search the run
    bounds, then read one K-wide window of child tokens per row and fold it
    into the (rows, K) mask, both in one launch (``children_window_mask``,
    the kernel's ``Mask`` epilogue; its twin on the CPU). With the kernel
    switch off (``ops/dispatch``) the window is gathered and folded in torch
    ops, JAX's route with Pallas disabled. For L = 0 pass shape (..., 0);
    the run is the whole level-1 table."""
    k = index.codebook_size
    batch_shape = prefix.shape[:-1]
    n_rows = math.prod(batch_shape)
    flat = prefix.reshape(n_rows, prefix.shape[-1])
    table, lo, cnt, key0 = children_window_inputs(index, flat)
    if dispatch.kernels_enabled():
        hits = children_window_mask(table, lo, cnt, key0, window=k, k_tokens=k)
    else:
        win_pos = lo.long()[:, None] + torch.arange(k, device=lo.device)
        in_run = win_pos < (lo + cnt).long()[:, None]
        child = table[win_pos.clamp(max=table.shape[0] - 1)] - key0[:, None]
        # JAX sums a one-hot of the tokens; fold_tokens scatters the same set
        hits = fold_tokens(torch.where(in_run & (child >= 0) & (child < k), child, k), k)
    return hits.reshape(*batch_shape, k)


def max_duplicates(index: CorpusIndex) -> int:
    """Largest dedup value; must stay < codebook_size for the decoder's
    level-offset embedding table."""
    return int(index.cached_ids[:, -1].max())


def tokenize_sequences(index: CorpusIndex, batch: SeqBatch) -> TokenizedSeqBatch:
    """Cached-ID gather: item-ID sequences -> semantic-ID token sequences."""
    b, n = batch.ids.shape
    d = index.cached_ids.shape[-1]
    n_items = index.cached_ids.shape[0]
    safe_ids = batch.ids.long().clamp(0, n_items - 1)
    sem_ids = index.cached_ids[safe_ids].reshape(b, n * d)
    seq_mask = torch.repeat_interleave(batch.seq_mask, d, dim=1)
    sem_ids = torch.where(seq_mask, sem_ids, -1)
    ids_fut = batch.ids_fut.long().clamp(0, n_items - 1).reshape(b)
    sem_ids_fut = index.cached_ids[ids_fut].reshape(b, d)
    levels = torch.arange(d, dtype=torch.int32, device=batch.ids.device)
    return TokenizedSeqBatch(
        user_ids=batch.user_ids,
        sem_ids=sem_ids,
        sem_ids_fut=sem_ids_fut,
        seq_mask=seq_mask,
        token_type_ids=levels.repeat(b, n),
        token_type_ids_fut=levels.repeat(b, 1),
    )


class PackedTokenizedBatch(NamedTuple):
    """A packed batch in semantic-ID token space (the packed counterpart of
    TokenizedSeqBatch): R rows x S segments, item tokens flattened to N*D."""

    user_ids: torch.Tensor        # (R, S) int32
    sem_ids: torch.Tensor         # (R, N*D) int32, -1 padded
    sem_ids_fut: torch.Tensor     # (R, S, D) int32
    seq_mask: torch.Tensor        # (R, N*D) bool
    token_type_ids: torch.Tensor  # (R, N*D) int32 in [0, D)
    seg_item: torch.Tensor        # (R, N) int32 slot per item, -1 pad
    slot_start: torch.Tensor      # (R, S) int32
    slot_len: torch.Tensor        # (R, S) int32
    slot_valid: torch.Tensor      # (R, S) bool


def tokenize_packed(index: CorpusIndex, packed) -> PackedTokenizedBatch:
    """Cached-ID gather for a packed batch (``data.packing.PackedSeqBatch``
    of tensors): item-ID rows carrying several user segments -> semantic-ID
    token rows. Per segment the same as ``tokenize_sequences``; the packing
    metadata passes through for the model to derive its attention spans."""
    r, n = packed.ids.shape
    d = index.cached_ids.shape[-1]
    n_items = index.cached_ids.shape[0]
    sem_ids = index.cached_ids[packed.ids.long().clamp(0, n_items - 1)].reshape(r, n * d)
    seq_mask = torch.repeat_interleave(packed.ids >= 0, d, dim=1)
    sem_ids = torch.where(seq_mask, sem_ids, -1)
    sem_ids_fut = index.cached_ids[packed.ids_fut.long().clamp(0, n_items - 1)]   # (R, S, D)
    levels = torch.arange(d, dtype=torch.int32, device=packed.ids.device)
    return PackedTokenizedBatch(
        user_ids=packed.user_ids,
        sem_ids=sem_ids,
        sem_ids_fut=sem_ids_fut,
        seq_mask=seq_mask,
        token_type_ids=levels.repeat(r, n),
        seg_item=packed.seg_item,
        slot_start=packed.slot_start,
        slot_len=packed.slot_len,
        slot_valid=packed.slot_valid,
    )
