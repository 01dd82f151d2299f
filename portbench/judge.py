"""The comparisons that decide ``correct``: each number the program's
output gives beside the reference's, and its limit (``limits/<cell>.json``).

Training numbers (a run's first three steps, the reference following them
from the same weights, batches and dropout masks):

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: the first step's gradient as the optimizer got it (from its
  first moment, ``mu / (1 - b1)``), by the worst leaf: the gap between the
  two norms of the leaf over the larger of the reference's norm of that
  leaf and of the median leaf;
* ``update_gap``: the parameters' change after three steps, by the worst
  leaf the same way, over the leaves whose reference gradient is above a
  thousandth of the median leaf's (a leaf with no gradient moves by
  round-off alone).

Serving numbers are in ``kinds/serve.py``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch


def loss_gap(program: Sequence[float], reference: Sequence[float]) -> float:
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(program, reference))


def norms(leaves: List[torch.Tensor]) -> torch.Tensor:
    return torch.stack([torch.linalg.vector_norm(x.double()) for x in leaves]).cpu()


def leaf_gap(program: List[torch.Tensor], reference: List[torch.Tensor],
             keep: Optional[torch.Tensor] = None) -> float:
    """Worst leaf's |norm(program) - norm(reference)| over
    max(norm(reference leaf), median reference leaf norm)."""
    p, r = norms(program), norms(reference)
    if keep is not None:
        p, r = p[keep], r[keep]
    scale = torch.clamp(r, min=float(torch.median(r)))
    return float(torch.max(torch.abs(p - r) / torch.clamp(scale, min=1e-30)))


def moving_leaves(ref_grads: List[torch.Tensor]) -> torch.Tensor:
    """The leaves whose reference gradient norm is above 1e-3 of the median
    leaf's."""
    g = norms(ref_grads)
    return g > 1e-3 * float(torch.median(g))


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, checks): every number within its limit (``<=``), and
    ``checks`` {number: {"value", "limit"}} in the limits' order. A number
    with no reading (NaN, missing) fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and value == value and value <= limit
        ok &= bool(good)
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
