"""DeepSeek-V2's feed-forward layers for the decoder-only retrieval model
(``models/retrieval_lm``): the dense SwiGLU of the leading layers and the
routed-plus-shared expert layer (``DeepseekV2MoE`` at inference).

SwiGLU: ``W_d (silu(x W_gate) * x W_up)``; the weights keep gate and up
side by side in one (in, 2 F) matrix.

Expert layer: the router is ``softmax(x W_g)`` in float32 over the
experts, and each token takes its ``top_k`` most likely experts (greedy,
weights not renormalised, times ``routed_scaling``). Only the routed
(token, expert) pairs are computed: the pairs are sorted by expert and run
through the experts' SwiGLU as two grouped GEMMs (``torch._grouped_mm``,
each expert's rows against its weights; the pair's weight applied to the
activation between them), and each token's outputs are summed in float32.
The experts' row ranges are found on the device (``searchsorted`` over the
sorted experts), so the layer never waits for the host.
The shared experts are one SwiGLU of ``n_shared * F`` over every token,
added after.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from rqvae_tpu_torch.utils import profiling


def swiglu(x: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    g, u = (x @ gate_up).chunk(2, dim=-1)
    return (F.silu(g) * u) @ down


def dense(p, x: torch.Tensor) -> torch.Tensor:
    with profiling.span("mlp.dense"):
        return swiglu(x, p["gate_up"], p["down"])


def route(p, cfg, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weights (T, top_k) float32, experts (T, top_k) int64) of tokens
    ``x`` (T, hidden)."""
    scores = torch.softmax(x.float() @ p["router"].float(), dim=-1)
    w, idx = torch.topk(scores, cfg.top_k, dim=-1)
    return w * cfg.routed_scaling, idx


def dispatch(idx: torch.Tensor, n_experts: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order, ends) of the pairs of ``idx`` (T, top_k): ``order`` the
    flattened pairs sorted by expert (stable), ``ends`` (E,) int32 each
    expert's last sorted row + 1, both found on the device."""
    order = torch.argsort(idx.flatten(), stable=True)
    bounds = torch.arange(n_experts, dtype=idx.dtype, device=idx.device)
    ends = torch.searchsorted(idx.flatten()[order], bounds, right=True, out_int32=True)
    return order, ends


def _experts(p, x: torch.Tensor, w: torch.Tensor, order: torch.Tensor,
             ends: torch.Tensor) -> torch.Tensor:
    """(T, hidden) float32: each token's expert outputs weighted and summed.
    The pairs run in ``order`` (sorted by expert), each product one grouped
    GEMM over the experts' row ranges (``ends``); a pair's weight scales its
    SwiGLU activation before the down product (the same product, by
    linearity), and each token's ``top_k`` rows are gathered back and
    summed in float32."""
    t, k = w.shape
    xs = x.index_select(0, order // k)
    g, u = torch._grouped_mm(xs, p["experts_gate_up"], offs=ends).chunk(2, dim=-1)
    hidden = F.silu(g).mul_(u).mul_(w.flatten()[order, None].to(x.dtype))
    ys = torch._grouped_mm(hidden, p["experts_down"], offs=ends)
    back = torch.empty_like(order)
    back[order] = torch.arange(order.numel(), device=order.device)
    return ys.index_select(0, back).view(t, k, -1).sum(dim=1, dtype=torch.float32)


def experts_layer(p, cfg, x: torch.Tensor, routes: Optional[list] = None) -> torch.Tensor:
    """The routed experts' weighted sum plus the shared experts, (T, hidden);
    each token's experts (T, top_k) are appended to ``routes`` if given."""
    with profiling.span("moe.route"):
        w, idx = route(p, cfg, x)
        if routes is not None:
            routes.append(idx)
        order, ends = dispatch(idx, p["experts_down"].shape[0])
    if profiling.enabled():
        counts = torch.diff(ends, prepend=ends.new_zeros(1))
        profiling.count("moe.pairs", idx.numel())
        profiling.count("moe.expert_pairs_max", counts.max())
        profiling.count("moe.experts_touched", (counts > 0).sum())
    with profiling.span("moe.experts"):
        routed = _experts(p, x, w, order, ends).to(x.dtype)
    with profiling.span("moe.shared"):
        return routed + swiglu(x, p["shared_gate_up"], p["shared_down"])
