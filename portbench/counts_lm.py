"""Operation and byte counts of the decoder-only retriever on DeepSeek-V2's
block (``reference/lm.py``'s sizes), beside ``counts.py``'s peaks.

Model flops (``mfu.serve``) count 2 flops a multiply-add over the valid
tokens only: each history token once through every layer at prefill (its
attention over the keys before it), then each decode step over its live
beam rows, the attention in the absorbed form against the history's valid
tokens and the beam's own. An expert layer counts the router and each
token's ``top_k`` routed experts and the shared experts; the dense layers
their SwiGLU. The head runs at each user's last history token and at every
decode row.

The expert products' bound (``moe_roofline.serve``) is the larger of their
operations (6 hidden F flops a computed pair) at the bf16 peak and their
bytes at the bandwidth: each touched expert's weights read once, and each
pair's input and output rows.
"""
from __future__ import annotations

from typing import Iterable

from portbench.counts import BYTES, HBM_BYTES_PER_S, PEAK_FLOPS


def _projections(s) -> int:
    """A token's flops in one layer's attention projections, W_kvb aside."""
    h = s.hidden
    return 2 * h * (s.heads * (s.nope + s.rope) + s.rank + s.rope + s.heads * s.v)


def _ffn(s, layer: int) -> int:
    h = s.hidden
    if layer < s.first_dense:
        return 6 * h * s.dense_width
    return 2 * h * s.experts + 6 * h * s.expert_width * (s.top_k + s.shared)


def search_flops(s, history_tokens: Iterable[int], k: int) -> float:
    """Model flops of one beam search of users whose sequences hold the
    given numbers of valid tokens (user token and history), ``k`` beams,
    ``s.sem_dim`` levels (the first from the prefill)."""
    heads, h = s.heads, s.hidden
    ffn = sum(_ffn(s, i) for i in range(s.layers))
    qk, pv = s.nope + s.rope, s.v
    total = 0.0
    for n in history_tokens:
        n = int(n)
        pre = n * (s.layers * (_projections(s) + 2 * s.rank * heads * (s.nope + pv)) + ffn)
        pre += s.layers * heads * (n * (n + 1) // 2) * 2 * (qk + pv) + 2 * h * s.codebook
        dec = 0.0
        for j in range(1, s.sem_dim):
            keys = n + j
            per = (_projections(s) + 2 * heads * s.rank * (s.nope + s.v)
                   + 2 * heads * keys * ((s.rank + s.rope) + s.rank))
            dec += k * (s.layers * per + ffn + 2 * h * s.codebook)
        total += pre + dec
    return total


def expert_bound_s(s, pairs: float, touched: float, dtype: str = "bfloat16") -> float:
    """Seconds the card needs at least for the routed experts' products of
    ``pairs`` (token, expert) pairs over ``touched`` (layer call, expert)
    weight sets."""
    h, f, el = s.hidden, s.expert_width, BYTES[dtype]
    flops = 6.0 * h * f * pairs
    nbytes = el * (3.0 * h * f * touched + 2.0 * h * pairs)
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)
