"""Gumbel-softmax temperature schedule for RQ-VAE training (the port's own
copy of rqvae_tpu/train/temperature.py).

An exponential anneal with a floor, stepped every ``step_size`` iterations,
in closed form; ``ConstantTemperature`` is the default (t = 0.2), the
schedule an opt-in (``gumbel_anneal=true``).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TemperatureScheduler:
    t0: float = 0.2
    min_t: float = 0.05
    anneal_rate: float = 1e-5
    step_size: int = 1000

    def get_t(self, it: int) -> float:
        """Reference semantics: anneal on the last iter of each window
        (gumbel.py:35-41), multiplicative ``t *= exp(-rate * it)`` with a
        floor — computed in CLOSED FORM so the schedule is STATELESS: the
        device-resident chunked loop samples t only at chunk starts, and a
        stateful trigger (``it % step_size == step_size-1``) would silently
        never fire there. K completed boundaries
        at iters k*step_size-1 give exponent sum K(K+1)/2*step_size - K;
        once the floor is hit the multiplicative chain stays there, so a
        single final max() is exact."""
        k = (it + 1) // self.step_size
        exponent_sum = self.step_size * k * (k + 1) // 2 - k
        return float(np.maximum(
            self.t0 * np.exp(-self.anneal_rate * exponent_sum), self.min_t
        ))


def constant_t_chunk_bound(it_start: int, step_size: int) -> int:
    """Longest chunk starting at ``it_start`` whose iters all share
    ``TemperatureScheduler.get_t``. The scheduler anneals ON iter
    k*step_size-1, so the constant-t windows are [k*step-1, (k+1)*step-2]
    — shifted one left of the log/eval cadence windows (a plain
    ``step - it%step`` clamp would run each boundary iter at the
    pre-anneal temperature). Used by the device-resident chunked loop
    (train_rqvae), which samples t once per chunk."""
    return ((it_start + 1) // step_size + 1) * step_size - 1 - it_start


class ConstantTemperature:
    def __init__(self, t: float):
        self.t = float(t)

    def get_t(self, it: int) -> float:
        return self.t
