"""Parameter initializers (counterpart of rqvae_tpu/utils/initializers.py).

Same distributions as the JAX package (which matches torch's module
defaults), drawn from an explicit ``torch.Generator``. The numbers differ
from ``jax.random`` for the same seed; parity tests copy JAX parameters in
through ``models.convert`` instead.

Weights are laid out (in, out) so the forward is ``x @ w``, as in JAX.
Tensors land on ``device``: cuda unless the caller says otherwise.
"""
from __future__ import annotations

import math

import torch

from rqvae_tpu_torch.utils.device import resolve_device


def _draw(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    u = torch.rand(tuple(shape), generator=gen, dtype=dtype, device=gen.device)
    return u.to(resolve_device(device))


def linear(gen: torch.Generator, in_dim: int, out_dim: int, *,
           dtype=torch.float32, device=None) -> torch.Tensor:
    """torch nn.Linear default init, transposed to (in, out)."""
    bound = 1.0 / math.sqrt(in_dim)
    return _draw(gen, (in_dim, out_dim), dtype, device) * (2 * bound) - bound


def uniform01(gen: torch.Generator, shape, *, dtype=torch.float32,
              device=None) -> torch.Tensor:
    """U(0, 1): codebooks and bos_emb."""
    return _draw(gen, shape, dtype, device)


def normal(gen: torch.Generator, shape, *, dtype=torch.float32,
           device=None) -> torch.Tensor:
    """N(0, 1): embedding tables."""
    t = torch.randn(tuple(shape), generator=gen, dtype=dtype, device=gen.device)
    return t.to(resolve_device(device))
