"""AdamW and the inverse-square-root schedule (counterpart of
rqvae_tpu/train/optim.py, which wraps ``optax.adamw``).

``adamw`` has optax's semantics over a parameter tree (nested dicts / lists
of tensors): bias-corrected first and second moments, ``eps`` outside the
square root, weight decay decoupled and applied to every leaf (no mask),
and the learning rate, a float or a schedule, read at the update count
starting from 0. Per step and leaf:

    mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu;  t += 1
    u  = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) + wd * p
    p += -lr(t - 1) * u

Unlike the functional JAX version, ``update`` changes the parameters and the
optimizer state in place (the step owns them; no second copy of a tree).
It runs over all leaves at once with ``torch._foreach_*`` ops.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Union

import torch

from rqvae_tpu_torch.utils.tree import tree_leaves, tree_map

Schedule = Callable[[int], float]


def inv_sqrt_schedule(base_lr: float, warmup_steps: int) -> Schedule:
    """Constant LR through warmup, then base_lr * sqrt(warmup / step):
    scale(s) = 1 for s <= warmup, else sqrt(warmup / s)."""

    def schedule(count: int) -> float:
        if count <= warmup_steps:
            return base_lr
        return base_lr * math.sqrt(warmup_steps / max(count, 1))

    return schedule


class AdamWState(NamedTuple):
    count: int     # updates applied so far
    mu: object     # first moments, the params' tree structure, fp32
    nu: object     # second moments


class AdamW(NamedTuple):
    learning_rate: Union[float, Schedule]
    weight_decay: float
    b1: float
    b2: float
    eps: float

    def init(self, params) -> AdamWState:
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
        return AdamWState(0, tree_map(zeros, params), tree_map(zeros, params))

    def lr(self, count: int) -> float:
        return self.learning_rate(count) if callable(self.learning_rate) else self.learning_rate

    def update(self, params, state: AdamWState, grads) -> AdamWState:
        """Apply one AdamW update to ``params`` in place; returns the new
        state (its moment tensors are updated in place too)."""
        p = tree_leaves(params)
        g = [t.float() for t in tree_leaves(grads)]
        mu, nu = tree_leaves(state.mu), tree_leaves(state.nu)
        if not (len(p) == len(g) == len(mu) == len(nu)):
            raise ValueError("params, grads and optimizer state differ in structure")
        t = state.count + 1
        lr = self.lr(state.count)
        with torch.no_grad():
            torch._foreach_mul_(mu, self.b1)
            torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
            torch._foreach_mul_(nu, self.b2)
            torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
            mu_hat = torch._foreach_div(mu, 1.0 - self.b1 ** t)
            denom = torch._foreach_div(nu, 1.0 - self.b2 ** t)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            upd = torch._foreach_div(mu_hat, denom)
            pf = [x.float() for x in p]
            if self.weight_decay:
                torch._foreach_add_(upd, pf, alpha=self.weight_decay)
            torch._foreach_mul_(upd, -lr)
            for x, u in zip(p, upd):
                x.add_(u.to(x.dtype))
        return AdamWState(t, state.mu, state.nu)


def adamw(learning_rate: Union[float, Schedule], weight_decay: float = 0.01, b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8) -> AdamW:
    return AdamW(learning_rate, weight_decay, b1, b2, eps)
