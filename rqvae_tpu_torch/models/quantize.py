"""One residual-quantization level (counterpart of rqvae_tpu/models/quantize.py).

* L2 / cosine distance matrix against the (out-projected) codebook;
* hard argmin ids;
* three gradient estimators for training:
    GUMBEL_SOFTMAX: soft weights @ codebook from gumbel_softmax(-dist, t)
    STE:            x + sg(emb - x)
    ROTATION_TRICK: Householder-style transform, sec. 4.2 of arXiv:2410.06424
* optional SimVQ out-projection and codebook l2-norm;
* eval path: hard lookup;
* quantize loss (codebook + commitment) in both paths.

JAX's ``stop_gradient`` is ``.detach()`` at the same places, and the eps
values are the JAX package's. Gumbel noise comes from the caller's
``torch.Generator``, or is passed in as uniform draws (``uniform``) so that
a test can feed both packages the same numbers.
"""
from __future__ import annotations

import enum
from typing import NamedTuple, Optional

import torch

from rqvae_tpu_torch.models.losses import quantize_loss
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


def gumbel_softmax_sample(logits: torch.Tensor, temperature: float, *,
                          generator: Optional[torch.Generator] = None,
                          uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax((logits + Gumbel(0,1)) / t). The U(0, 1) draws are ``uniform``
    when given, else drawn from ``generator``."""
    eps = 1e-20
    if uniform is None:
        if generator is None:
            raise ValueError("the Gumbel estimator needs a generator or uniform draws")
        uniform = torch.rand(logits.shape, generator=generator, dtype=logits.dtype,
                             device=logits.device)
    g = -torch.log(-torch.log(uniform.to(logits.dtype) + eps) + eps)
    return torch.softmax((logits + g) / temperature, dim=-1)


def _rotation_trick(u: torch.Tensor, q: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """e - 2 (e.w) w + 2 (e.u) q with w = unit(u + q); u, q and w detached,
    so the gradient flows through ``e`` alone."""
    w = l2norm(u + q, eps=1e-6).detach()
    ew = torch.sum(e * w, dim=-1, keepdim=True)
    eu = torch.sum(e * u.detach(), dim=-1, keepdim=True)
    return e - 2.0 * ew * w + 2.0 * eu * q.detach()


def apply(params, x: torch.Tensor, *, temperature: float = 0.001,
          mode: QuantizeForwardMode = QuantizeForwardMode.GUMBEL_SOFTMAX,
          distance: QuantizeDistance = QuantizeDistance.L2, normalize: bool = False,
          commitment_weight: float = 0.25, training: bool = False,
          generator: Optional[torch.Generator] = None,
          uniform: Optional[torch.Tensor] = None) -> QuantizeOutput:
    """One quantization level; ``training`` selects the estimator ``mode``."""
    codebook = effective_codebook(params, normalize=normalize, dtype=x.dtype)
    dist = distances(x, codebook, distance)
    ids = torch.argmin(dist.detach(), dim=-1).to(torch.int32)

    if not training:
        emb_out = codebook[ids.long()]
        return QuantizeOutput(embeddings=emb_out, ids=ids,
                              loss=quantize_loss(x, emb_out, commitment_weight))
    if mode == QuantizeForwardMode.GUMBEL_SOFTMAX:
        weights = gumbel_softmax_sample(-dist, temperature, generator=generator, uniform=uniform)
        emb = weights @ codebook
        emb_out = emb
    elif mode == QuantizeForwardMode.STE:
        emb = codebook[ids.long()]
        emb_out = x + (emb - x).detach()
    elif mode == QuantizeForwardMode.ROTATION_TRICK:
        emb = codebook[ids.long()]
        x_norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        emb_norm = torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
        rot = _rotation_trick(x / (x_norm + 1e-8), emb / (emb_norm + 1e-8), x)
        scale = (emb_norm / (x_norm + 1e-6)).detach()
        emb_out = rot * scale
    else:
        raise ValueError(f"Unsupported forward mode: {mode}")
    return QuantizeOutput(embeddings=emb_out, ids=ids,
                          loss=quantize_loss(x, emb, commitment_weight))
