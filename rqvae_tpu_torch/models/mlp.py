"""Bias-free SiLU MLP (counterpart of rqvae_tpu/models/mlp.py).

Params are a list of (in, out) weight matrices; compute dtype follows ``x``.
In training, dropout follows each SiLU, drawn from the caller's generator.

Under tensor parallelism (``parallel/tensor``) the layers alternate as JAX's
rules split them: even layers column-parallel (the input copied to the
model group, the output a slice of the hidden width), odd layers
row-parallel (a partial product, then one ``all_reduce``); a stack that ends
on a column layer gathers its output. The MLPs have no bias, so nothing is
added after a reduce.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from rqvae_tpu_torch.models.dropout import dropout as _dropout
from rqvae_tpu_torch.models.normalize import l2norm
from rqvae_tpu_torch.parallel import tensor as tp
from rqvae_tpu_torch.utils import initializers
from rqvae_tpu_torch.utils.device import resolve_device


def init(gen: torch.Generator, input_dim: int, hidden_dims: Sequence[int],
         out_dim: int, *, device=None) -> List[torch.Tensor]:
    """Weights [(d0, d1), (d1, d2), ...] on ``device`` (cuda unless told otherwise)."""
    device = resolve_device(device)
    dims = [input_dim, *hidden_dims, out_dim]
    return [
        initializers.linear(gen, d_in, d_out, device=device)
        for d_in, d_out in zip(dims[:-1], dims[1:])
    ]


def apply(params: List[torch.Tensor], x: torch.Tensor, *, dropout: float = 0.0,
          normalize: bool = False, training: bool = False,
          generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """SiLU between layers, never after the last, dropout after each SiLU
    when training; optional final l2norm."""
    in_dim = params[0].shape[0]
    if x.shape[-1] != in_dim:
        raise ValueError(f"Invalid input dim: expected {in_dim}, found {x.shape[-1]}")
    n = len(params)
    split = tp.size() > 1
    for i, w in enumerate(params):
        column = split and i % 2 == 0
        if column:
            x = tp.copy_to_model(x)
        x = x @ w.to(x.dtype)
        if split and not column:
            x = tp.reduce_from_model(x)
        if i != n - 1:
            x = _dropout(F.silu(x), dropout, training, generator, sharded=column)
        elif column:
            x = tp.gather_from_model(x)
    if normalize:
        x = l2norm(x)
    return x
