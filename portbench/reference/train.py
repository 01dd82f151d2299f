"""The plain reference of one decoder training step: the cached-ID lookup
that turns item histories into semantic-ID tokens, the length buckets, the
forward and backward of ``model.train_loss``, the gradient sum over the
buckets (each weighted 1 / buckets) and one AdamW update.

AdamW is optax's, with decoupled weight decay on every leaf and the
learning rate read at the update count before the increment::

    mu = b1 mu + (1 - b1) g;  nu = b2 nu + (1 - b2) g^2;  t += 1
    p -= lr(t - 1) * ((mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) + wd p)

under the inverse-square-root schedule: ``lr`` through ``warmup`` updates,
then ``lr * sqrt(warmup / t)``.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np
import torch

from portbench.reference import model as ref_model


def leaves(tree) -> List[torch.Tensor]:
    """Leaves in a fixed order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def rebuild(tree, flat):
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            out = dict.fromkeys(t)
            for k in sorted(t):
                out[k] = build(t[k])
            return out
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(tree)


class Optimizer(NamedTuple):
    lr: float
    weight_decay: float
    warmup: int
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def rate(self, count: int) -> float:
        return self.lr if count <= self.warmup else self.lr * math.sqrt(self.warmup / max(count, 1))


def optimizer(dec: dict) -> Optimizer:
    """The configuration's AdamW (the decoder trainer's defaults where the
    file sets none: lr 1e-3, weight decay 0.01, 10,000 warm-up updates)."""
    return Optimizer(float(dec.get("learning_rate", 0.001)), float(dec.get("weight_decay", 0.01)),
                     int(dec.get("warmup_steps", 10000)))


def buckets(lengths: np.ndarray, n: int, grid: int = 4):
    """Rows sorted by history length, longest first (ties in row order), in
    ``n`` equal groups, each padded to its longest history rounded up to
    ``grid`` items: [(rows, pad length)]."""
    order = np.argsort(-lengths, kind="stable")
    size = len(order) // n
    out = []
    for g in range(n):
        rows = order[g * size:(g + 1) * size]
        lmax = max(1, int(lengths[rows].max()))
        out.append((rows, -(-lmax // grid) * grid))
    return out


def tokens(cached: torch.Tensor, ids: np.ndarray, fut: np.ndarray):
    """Item ids (B, N) (-1 past the history) and targets (B,) to
    (sem_ids (B, N * D), mask (B, N * D), target tokens (B, D)) through the
    corpus table ``cached`` (n_items, D); ids outside the table read its
    first or last row."""
    dev = cached.device
    n_items, d = cached.shape
    ids_t = torch.from_numpy(np.ascontiguousarray(ids)).to(dev).long()
    mask = (ids_t >= 0).repeat_interleave(d, dim=1)
    sem = cached[ids_t.clamp(0, n_items - 1)].reshape(ids_t.shape[0], -1)
    sem = torch.where(mask, sem, -1)
    fut_t = torch.from_numpy(np.ascontiguousarray(fut).reshape(-1)).to(dev).long()
    return sem, mask, cached[fut_t.clamp(0, n_items - 1)]


def gradients(params, s: ref_model.DecoderShape, cached: torch.Tensor, raw: dict, n_buckets: int,
              gen: torch.Generator):
    """(loss, gradient leaves) of one sampled batch ``raw`` (``user_ids``,
    ``ids``, ``ids_fut`` as the sampler gives them): the buckets' losses
    and gradients, each weighted 1 / buckets. ``gen`` replays the dropout."""
    flat = leaves(params)
    grads = [torch.zeros_like(p) for p in flat]
    loss = 0.0
    ids = raw["ids"]
    groups = (buckets((ids >= 0).sum(axis=1), n_buckets) if n_buckets > 1
              else [(np.arange(ids.shape[0]), ids.shape[1])])
    for rows, length in groups:
        sem, mask, fut = tokens(cached, ids[rows, :length], raw["ids_fut"][rows])
        users = torch.from_numpy(raw["user_ids"][rows]).to(cached.device)
        leaf = [p.detach().requires_grad_(True) for p in flat]
        lo, _ = ref_model.train_loss(rebuild(params, leaf), s, sem, mask, users, fut, gen)
        g = torch.autograd.grad(lo, leaf)
        w = 1.0 / len(groups)
        for acc, x in zip(grads, g):
            acc.add_(x, alpha=w)
        loss += w * float(lo.detach())
    return loss, grads


def adamw(params, moments, count: int, opt: Optimizer, grads):
    """One AdamW update; returns (new params, new (mu, nu))."""
    flat = leaves(params)
    mu, nu = moments
    t = count + 1
    lr = opt.rate(count)
    new_p, new_mu, new_nu = [], [], []
    with torch.no_grad():
        for p, g, m, v in zip(flat, grads, mu, nu):
            m = opt.b1 * m + (1 - opt.b1) * g
            v = opt.b2 * v + (1 - opt.b2) * g * g
            u = (m / (1 - opt.b1 ** t)) / (torch.sqrt(v / (1 - opt.b2 ** t)) + opt.eps)
            new_p.append(p - lr * (u + opt.weight_decay * p))
            new_mu.append(m)
            new_nu.append(v)
    return rebuild(params, new_p), (new_mu, new_nu)
