"""Retrieval eval metrics (counterpart of rqvae_tpu/evaluate/metrics.py).

``h@K_slice_:i``: the actual tuple's length-i prefix appears among the top-K
beams; ``h@K_pos_i``: position i alone matches in some top-K beam;
``ndcg@K``: the exact-item match at rank r contributes 1/log2(r+2).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch


def batch_hit_counts(actual: torch.Tensor, top_k: torch.Tensor,
                     ks: Sequence[int] = (1, 5, 10),
                     valid: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Hit counts for one batch: actual (B, D), top_k (B, n_beams, D);
    rows with ``valid`` False are not counted."""
    b, d = actual.shape
    if valid is None:
        valid = torch.ones((b,), dtype=torch.bool, device=actual.device)
    pos_match = actual[:, None, :] == top_k  # (B, n_beams, D)
    out: Dict[str, torch.Tensor] = {}

    def found_rank(match):
        found = torch.any(match, dim=-1) & valid
        rank = torch.argmax(match.to(torch.int8), dim=-1)  # first hit
        return found, rank

    for i in range(d):
        for name, match in (
            (f"slice_:{i + 1}", torch.all(pos_match[..., : i + 1], dim=-1)),
            (f"pos_{i}", pos_match[..., i]),
        ):
            found, rank = found_rank(match)
            for kk in ks:
                out[f"h@{kk}_{name}"] = torch.sum(found & (rank < kk))
    found, rank = found_rank(torch.all(pos_match, dim=-1))
    gain = 1.0 / torch.log2(rank.float() + 2.0)
    for kk in ks:
        out[f"ndcg@{kk}"] = torch.sum(torch.where(found & (rank < kk), gain, 0.0))
    return out


class TopKAccumulator:
    """Host-side accumulator of hit counts; ``reduce`` gives rates."""

    def __init__(self, ks: Sequence[int] = (1, 5, 10)):
        self.ks = tuple(ks)
        self.reset()

    def reset(self) -> None:
        self.total = 0
        self.metrics: Dict[str, float] = {}

    def accumulate(self, actual: torch.Tensor, top_k: torch.Tensor) -> None:
        self.accumulate_counts(batch_hit_counts(actual, top_k, self.ks), int(actual.shape[0]))

    def accumulate_counts(self, counts: Dict[str, object], n_rows: int) -> None:
        for key, value in counts.items():
            self.metrics[key] = self.metrics.get(key, 0.0) + float(value)
        self.total += int(n_rows)

    def reduce(self) -> Dict[str, float]:
        return {k: v / self.total for k, v in self.metrics.items()}
