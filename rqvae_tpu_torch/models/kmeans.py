"""Full-batch Lloyd's k-means for codebook initialization (counterpart of
rqvae_tpu/models/kmeans.py).

* init: k centroids sampled without replacement from x;
* assignment: argmin of ((||x||^2 - 2 x.c) + ||c||^2), JAX's term order;
* update: cluster means through a one-hot matmul (deterministic on the GPU,
  where ``index_add_`` sums with atomics in no fixed order); empty clusters
  reseeded from a random row of x, drawn every iteration as in JAX;
* stop when the largest centroid shift is < ``stop_threshold`` (1e-10) or
  after ``max_iters`` (300) iterations.

fp32 throughout. JAX runs the loop in ``lax.while_loop``; here the shift is
read on the host once per iteration (one sync each), which is set-up time.
``refine`` is the loop from given centroids, so a test can start both
packages from the same ones.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class KmeansOutput(NamedTuple):
    centroids: torch.Tensor   # (K, D)
    assignment: torch.Tensor  # (B,) int32


def _assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    d = (
        torch.sum(x * x, dim=-1, keepdim=True)
        - 2.0 * x @ centroids.T
        + torch.sum(centroids * centroids, dim=-1)[None, :]
    )
    return torch.argmin(d, dim=-1).to(torch.int32)


def refine(x: torch.Tensor, centroids: torch.Tensor, generator: torch.Generator, *,
           max_iters: int = 300, stop_threshold: float = 1e-10) -> KmeansOutput:
    """Lloyd's iterations on x (B, D) from ``centroids`` (K, D)."""
    x = x.float()
    centroids = centroids.float()
    b = x.shape[0]
    k = centroids.shape[0]
    shift = float("inf")
    i = 0
    while i < max_iters and shift >= stop_threshold:
        onehot = F.one_hot(_assign(x, centroids).long(), k).to(torch.float32)  # (B, K)
        counts = torch.sum(onehot, dim=0)
        means = (onehot.T @ x) / torch.clamp(counts, min=1.0)[:, None]
        reseed = torch.randint(0, b, (k,), generator=generator, device=generator.device)
        new = torch.where((counts > 0)[:, None], means, x[reseed.to(x.device)])
        shift = float(torch.max(torch.linalg.vector_norm(new - centroids, dim=-1)))
        centroids = new
        i += 1
    return KmeansOutput(centroids=centroids, assignment=_assign(x, centroids))


def kmeans(x: torch.Tensor, k: int, *, generator: torch.Generator, max_iters: int = 300,
           stop_threshold: float = 1e-10) -> KmeansOutput:
    """Run Lloyd's algorithm on x (B, D) from k distinct rows drawn from
    ``generator``."""
    x = x.float()
    init_idx = torch.randperm(x.shape[0], generator=generator, device=generator.device)[:k]
    return refine(x, x[init_idx.to(x.device)], generator, max_iters=max_iters,
                  stop_threshold=stop_threshold)
