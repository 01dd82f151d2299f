"""Operation and byte counts of the algorithm (never of an implementation)
and the table of peaks they are held against.

Peaks of one NVIDIA H100 SXM (the data sheet's dense rates at 700 W): fp32
work is counted against the TF32 tensor-core peak, the highest rate at
which any fp32-accurate product can run on the card, so no implementation
(three TF32 products, CUDA cores) can read above 100 %; bf16 against the
bf16 peak; bytes against HBM3's 3.35 TB/s.

Model FLOPs (``mfu.*``) count 2 flops a multiply-add over the valid tokens
only: no padding, no recomputation, the backward twice the forward.
Attention counts the pairs the masks allow. An attention call's bound
(``attn_roofline.*``) is the larger of its operations over the peak and its
bytes over the bandwidth: 4 Dh flops a (head, pair) forward, 8 Dh backward;
the forward reads q, K and V over the keys its pairs touch and writes the
output; the backward reads q, K, V and the output's gradient and writes the
three gradients.
"""
from __future__ import annotations

from typing import Iterable, NamedTuple

import numpy as np

PEAK_FLOPS = {"float32": 494.7e12, "bfloat16": 989.4e12}
HBM_BYTES_PER_S = 3.35e12
BYTES = {"float32": 4, "bfloat16": 2}


class Shape(NamedTuple):
    """The decoder's sizes as the counts need them."""

    embedding_dim: int
    attn_dim: int
    heads: int
    enc_layers: int
    dec_layers: int
    mlp_dim: int
    codebook: int
    sem_dim: int


def shape_of(s) -> Shape:
    """From a ``reference.model.DecoderShape``."""
    return Shape(s.embedding_dim, s.attn_dim, s.heads, s.layers // 2, s.layers // 2, s.mlp_dim,
                 s.codebook, s.sem_dim)


def _block_token(a: int, f: int) -> int:
    """Forward flops a token of one encoder block outside attention."""
    return 2 * (4 * a * a + 2 * a * f)


def train_flops(s: Shape, history_items: Iterable[int]) -> float:
    """Model flops (forward and backward) of one training step over rows
    of the given valid history lengths (in items)."""
    a, e, f, d = s.attn_dim, s.embedding_dim, s.mlp_dim, s.sem_dim
    n_fut = d + 1                       # BOS and the D target tokens
    total = 0.0
    for n in history_items:
        t = int(n) * d + 1              # valid encoder tokens: the user token and the items'
        enc = s.enc_layers * (t * _block_token(a, f) + 4 * a * t * t)
        dec_tok = 2 * (4 * a * a + 2 * a * a + 2 * a * f)   # self qkv + proj, cross q + proj, MLP
        dec = s.dec_layers * (n_fut * dec_tok + 2 * 2 * a * a * t          # cross K / V of the context
                              + 4 * a * n_fut * (n_fut + 1) // 2 + 4 * a * n_fut * t)
        proj = 2 * e * a * (t + n_fut) + 2 * a * s.codebook * d
        total += enc + dec + proj
    return 3.0 * total


def search_flops(s: Shape, history_items: Iterable[int], k: int) -> float:
    """Model flops of one beam search over histories of the given valid
    lengths: the encoder over the valid tokens, the cross K / V once, then
    D decode steps, the first over one beam a history, the others over k,
    each new token through every decoder block against its cache."""
    a, e, f, d = s.attn_dim, s.embedding_dim, s.mlp_dim, s.sem_dim
    total = 0.0
    for n in history_items:
        t = int(n) * d + 1
        total += s.enc_layers * (t * _block_token(a, f) + 4 * a * t * t) + 2 * e * a * t
        total += s.dec_layers * 2 * 2 * a * a * t
        for step in range(d):
            beams = 1 if step == 0 else k
            per = s.dec_layers * (2 * (4 * a * a + 2 * a * a + 2 * a * f)
                                  + 4 * a * (step + 1) + 4 * a * t)
            total += beams * (per + 2 * e * a + 2 * a * s.codebook)
    return total


class Call(NamedTuple):
    """One attention call: ``pairs`` allowed (query, key) pairs summed over
    the batch, ``q_rows`` query rows, ``k_rows`` keys touched, for ``heads``
    heads of width ``dh``."""

    pairs: int
    q_rows: int
    k_rows: int
    heads: int
    dh: int


def key_mask_call(valid_keys: np.ndarray, nq: int, heads: int, dh: int) -> Call:
    """A call whose every query row attends the valid keys of its batch row."""
    v = np.asarray(valid_keys, np.int64)
    return Call(int(nq * v.sum()), int(nq * len(v)), int(v.sum()), heads, dh)


def causal_call(rows: int, n: int, heads: int, dh: int) -> Call:
    return Call(rows * n * (n + 1) // 2, rows * n, rows * n, heads, dh)


def bound_s(call: Call, direction: str, dtype: str = "float32") -> float:
    """Seconds the card needs at least for one call, ``fwd`` or ``bwd``."""
    hd = call.heads * call.dh
    el = BYTES[dtype]
    if direction == "fwd":
        flops = 4 * call.dh * call.heads * call.pairs
        nbytes = el * hd * (2 * call.q_rows + 2 * call.k_rows)
    else:
        flops = 8 * call.dh * call.heads * call.pairs
        nbytes = el * hd * (4 * call.q_rows + 4 * call.k_rows)
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def train_attention_calls(s: Shape, groups):
    """Every attention call of one training step, given its buckets as
    (valid history items a row, padded items a row): per bucket and
    layer, the encoder's self attention under the key mask, the decoder's
    causal self attention and its cross attention under the key mask."""
    dh = s.attn_dim // s.heads
    calls = []
    n_fut = s.sem_dim + 1
    for items, pad in groups:
        items = np.asarray(items, np.int64)
        valid = items * s.sem_dim + 1
        n_ctx = int(pad) * s.sem_dim + 1
        calls += [key_mask_call(valid, n_ctx, s.heads, dh)] * s.enc_layers
        calls += [causal_call(len(items), n_fut, s.heads, dh)] * s.dec_layers
        calls += [key_mask_call(valid, n_fut, s.heads, dh)] * s.dec_layers
    return calls


def search_attention_calls(s: Shape, items: np.ndarray, width: int, k: int):
    """Every attention call of one beam search over histories with
    ``items`` valid items a row, padded to ``width`` items: the encoder's
    self attention; per decode step and block, the new token's self
    attention over the cache and the beams' cross attention."""
    dh = s.attn_dim // s.heads
    items = np.asarray(items, np.int64)
    valid = items * s.sem_dim + 1
    b = len(items)
    calls = [key_mask_call(valid, width * s.sem_dim + 1, s.heads, dh)] * s.enc_layers
    for step in range(s.sem_dim):
        beams = 1 if step == 0 else k
        self_call = Call(b * beams * (step + 1), b * beams, b * beams * (step + 1), s.heads, dh)
        calls += [self_call, key_mask_call(valid, beams, s.heads, dh)] * s.dec_layers
    return calls
