"""The plain reference of constrained beam search: at each of the tuple's D
positions every beam's next-token log-probabilities, -10000 added to each
token the corpus does not allow after the beam's prefix, plus the beam's
score so far, and the k best of all (beam, token) pairs kept. The first
position starts from BOS alone. No KV cache: each position decodes the
whole prefix again.

``rescore`` gives the score that search assigns to a given tuple: the sum
over its positions of the token's log-probability plus its penalty.
"""
from __future__ import annotations

import torch

from portbench.reference import model as ref_model
from portbench.reference.corpus import Prefixes

PENALTY = -10000.0


def _repeat(t: torch.Tensor, k: int) -> torch.Tensor:
    return t.repeat_interleave(k, dim=0)


def beam_search(params, s: ref_model.DecoderShape, context, ctx_mask, prefixes: Prefixes, k: int):
    """(tuples (B, k, D), scores (B, k)), best first."""
    b = context.shape[0]
    kk = s.codebook
    fut = torch.zeros((b, 0), dtype=torch.long, device=context.device)
    logp = ref_model.target_logp(params, s, context, ctx_mask, fut)[:, -1]
    scores = torch.where(prefixes.allowed(fut), 0.0, PENALTY) + logp
    best, idx = torch.topk(scores, k, dim=-1)
    tuples = idx[..., None]
    ctx_k, mask_k = _repeat(context, k), _repeat(ctx_mask, k)
    rows = torch.arange(b, device=context.device)[:, None]
    for i in range(1, s.sem_dim):
        flat = tuples.reshape(b * k, i)
        logp = ref_model.target_logp(params, s, ctx_k, mask_k, flat)[:, -1]
        scores = (torch.where(prefixes.allowed(flat), 0.0, PENALTY) + logp
                  + best.reshape(b * k, 1)).reshape(b, k * kk)
        best, top = torch.topk(scores, k, dim=-1)
        tuples = torch.cat([tuples[rows, top // kk], (top % kk)[..., None]], dim=-1)
    return tuples, best


def rescore(params, s: ref_model.DecoderShape, context, ctx_mask, prefixes: Prefixes,
            tuples: torch.Tensor) -> torch.Tensor:
    """(B, k) scores of the tuples (B, k, D) of each history."""
    b, k, d = tuples.shape
    flat = tuples.reshape(b * k, d).long()
    logp = ref_model.target_logp(params, s, _repeat(context, k), _repeat(ctx_mask, k),
                                 flat[:, :d - 1])                      # (B k, D, K)
    total = torch.zeros(b * k, device=context.device)
    for i in range(d):
        ok = prefixes.allowed(flat[:, :i]).gather(1, flat[:, i:i + 1].clamp(0, s.codebook - 1))[:, 0]
        tok = logp[:, i].gather(1, flat[:, i:i + 1].clamp(0, s.codebook - 1))[:, 0]
        total = total + torch.where(ok, 0.0, PENALTY) + tok
    return total.reshape(b, k)
