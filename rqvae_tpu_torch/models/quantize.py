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

Under tensor parallelism (``parallel/tensor``; JAX's ``_rqvae_tp_spec``)
each rank of a model group holds K / m codewords (``sim_proj`` by columns,
gathered whole before use). Each rank computes its (B, K / m) distances; the
ids are the cross-shard argmin (the lowest global index on ties, as
``torch.argmin``); a chosen codeword comes from its owner, a masked gather
then an ``all_reduce``, so its gradient reaches only the owner's rows. STE
and the rotation trick then act on whole tensors, as on one process. The
Gumbel estimator draws the whole (B, K) noise from the generator (seeded
alike across the group) and keeps its columns; its softmax over K takes a
max and a sum over the group, and the soft codeword is a partial sum then an
``all_reduce``.
"""
from __future__ import annotations

import enum
from typing import NamedTuple, Optional

import torch

from rqvae_tpu_torch.models.losses import quantize_loss
from rqvae_tpu_torch.models.normalize import l2norm
from rqvae_tpu_torch.parallel import tensor as tp
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
    """SimVQ projection then optional l2-norm (the rank's codewords under
    tensor parallelism, projected by the whole, gathered ``sim_proj``)."""
    cb = params["codebook"].to(dtype)
    if "sim_proj" in params:
        # gathered whole; each rank's rows give part of its gradient, summed
        cb = cb @ tp.copy_to_model(tp.gather_from_model(params["sim_proj"].to(dtype)))
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
    when given, else drawn from ``generator``. Under tensor parallelism
    ``logits`` is the rank's columns of (B, K), ``uniform`` the whole (B, K)
    draws, and the softmax runs over the model group's columns."""
    eps = 1e-20
    m = tp.size()
    if uniform is None:
        if generator is None:
            raise ValueError("the Gumbel estimator needs a generator or uniform draws")
        shape = (*logits.shape[:-1], logits.shape[-1] * m)
        uniform = torch.rand(shape, generator=generator, dtype=logits.dtype,
                             device=logits.device)
    uniform = tp.own_slice(uniform)
    g = -torch.log(-torch.log(uniform.to(logits.dtype) + eps) + eps)
    z = (logits + g) / temperature
    if m == 1:
        return torch.softmax(z, dim=-1)
    e = torch.exp(z - tp.max_over_model(torch.amax(z, dim=-1, keepdim=True)))
    return e / tp.all_reduce_model(torch.sum(e, dim=-1, keepdim=True))


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
    """One quantization level; ``training`` selects the estimator ``mode``.
    Under tensor parallelism ``params`` holds the rank's codewords (see the
    module docstring) and every output is whole."""
    codebook = effective_codebook(params, normalize=normalize, dtype=x.dtype)
    # the whole x against the rank's codewords: its gradient sums over the group
    dist = distances(tp.copy_to_model(x), codebook, distance)
    offset = tp.index() * codebook.shape[0]
    ids = tp.argmin_over_model(dist, offset)

    def lookup():
        if tp.size() == 1:
            return codebook[ids.long()]
        local = ids.long() - offset
        own = (local >= 0) & (local < codebook.shape[0])
        rows = codebook[local.clamp(0, codebook.shape[0] - 1)]
        return tp.reduce_from_model(torch.where(own[:, None], rows, 0.0))

    if not training:
        emb_out = lookup()
        return QuantizeOutput(embeddings=emb_out, ids=ids,
                              loss=quantize_loss(x, emb_out, commitment_weight))
    if mode == QuantizeForwardMode.GUMBEL_SOFTMAX:
        weights = gumbel_softmax_sample(-dist, temperature, generator=generator, uniform=uniform)
        emb = tp.reduce_from_model(weights @ codebook)
        emb_out = emb
    elif mode == QuantizeForwardMode.STE:
        emb = lookup()
        emb_out = x + (emb - x).detach()
    elif mode == QuantizeForwardMode.ROTATION_TRICK:
        emb = lookup()
        x_norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        emb_norm = torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
        rot = _rotation_trick(x / (x_norm + 1e-8), emb / (emb_norm + 1e-8), x)
        scale = (emb_norm / (x_norm + 1e-6)).detach()
        emb_out = rot * scale
    else:
        raise ValueError(f"Unsupported forward mode: {mode}")
    return QuantizeOutput(embeddings=emb_out, ids=ids,
                          loss=quantize_loss(x, emb, commitment_weight))
