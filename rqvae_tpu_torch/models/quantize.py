"""One residual-quantization level (counterpart of rqvae_tpu/models/quantize.py).

Eval path only: hard argmin ids and the codeword lookup. The training
estimators (Gumbel softmax, STE, rotation trick) come with stage-1 training.
"""
from __future__ import annotations

import enum
from typing import NamedTuple

import torch

from rqvae_tpu_torch.models.normalize import l2norm
from rqvae_tpu_torch.utils import initializers
from rqvae_tpu_torch.utils.device import resolve_device


class QuantizeForwardMode(enum.Enum):
    GUMBEL_SOFTMAX = 1
    STE = 2
    ROTATION_TRICK = 3


class QuantizeDistance(enum.Enum):
    L2 = 1
    COSINE = 2


class QuantizeOutput(NamedTuple):
    embeddings: torch.Tensor  # (B, D)
    ids: torch.Tensor         # (B,) int32
    loss: torch.Tensor        # (B,)


def init(gen: torch.Generator, n_embed: int, embed_dim: int,
         sim_vq: bool = False, *, device=None):
    device = resolve_device(device)
    params = {"codebook": initializers.uniform01(gen, (n_embed, embed_dim), device=device)}
    if sim_vq:
        params["sim_proj"] = initializers.linear(gen, embed_dim, embed_dim, device=device)
    return params


def effective_codebook(params, *, normalize: bool = False,
                       dtype=torch.float32) -> torch.Tensor:
    """SimVQ projection then optional l2-norm."""
    cb = params["codebook"].to(dtype)
    if "sim_proj" in params:
        cb = cb @ params["sim_proj"].to(dtype)
    if normalize:
        cb = l2norm(cb)
    return cb


def distances(x: torch.Tensor, codebook: torch.Tensor,
              mode: QuantizeDistance = QuantizeDistance.L2) -> torch.Tensor:
    """(B, K) distance matrix, terms in the JAX order ||x||^2 + ||cb||^2 - 2 x.cb."""
    if mode == QuantizeDistance.L2:
        return (
            torch.sum(x * x, dim=-1, keepdim=True)
            + torch.sum(codebook * codebook, dim=-1)[None, :]
            - 2.0 * x @ codebook.T
        )
    if mode == QuantizeDistance.COSINE:
        xn = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        cn = codebook / torch.linalg.vector_norm(codebook, dim=-1, keepdim=True)
        return -(xn @ cn.T)
    raise ValueError(f"Unsupported distance mode: {mode}")


def quantize_loss(query: torch.Tensor, value: torch.Tensor,
                  commitment_weight: float = 0.25) -> torch.Tensor:
    """Codebook + commitment loss value (row-wise)."""
    sq = torch.sum((query - value) ** 2, dim=-1)
    return sq + commitment_weight * sq


def apply(params, x: torch.Tensor, *, distance: QuantizeDistance = QuantizeDistance.L2,
          normalize: bool = False, commitment_weight: float = 0.25,
          training: bool = False) -> QuantizeOutput:
    """One quantization level, eval mode (hard lookup)."""
    if training:
        raise NotImplementedError("training estimators are not ported yet")
    codebook = effective_codebook(params, normalize=normalize, dtype=x.dtype)
    dist = distances(x, codebook, distance)
    ids = torch.argmin(dist, dim=-1).to(torch.int32)
    emb = codebook[ids.long()]
    return QuantizeOutput(embeddings=emb, ids=ids,
                          loss=quantize_loss(x, emb, commitment_weight))
