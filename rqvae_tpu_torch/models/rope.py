"""Rotary position embedding with YaRN frequency scaling, as DeepSeek-V2
builds it (``DeepseekV2YarnRotaryEmbedding``, ``apply_rotary_pos_emb``).

The rotary dims' inverse frequencies blend the plain ``theta^(-2i/d)`` with
the same over ``factor``: a linear ramp between the correction dims of
``beta_fast`` and ``beta_slow`` rotations at ``original_max`` positions keeps
the fast dims plain and interpolates the slow ones. The cos / sin table is
``cat(freqs, freqs)`` times ``mscale(factor, mscale) / mscale(factor,
mscale_all_dim)`` (1 when the two are equal, as in DeepSeek-V2-Lite); the
attention's softmax scale takes ``mscale(factor, mscale_all_dim)^2``.

``apply`` rotates in DeepSeek's layout: the input's interleaved pairs are
first de-interleaved (evens then odds), then rotated by rotate-half.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch


class Yarn(NamedTuple):
    dim: int              # rotary dims
    theta: float
    factor: float
    original_max: int
    beta_fast: float
    beta_slow: float
    mscale: float
    mscale_all_dim: float


def mscale(factor: float, m: float) -> float:
    return 0.1 * m * math.log(factor) + 1.0 if factor > 1 else 1.0


def _correction_dim(rotations: float, dim: int, theta: float, max_pos: int) -> float:
    return dim * math.log(max_pos / (rotations * 2 * math.pi)) / (2 * math.log(theta))


def inv_freq(y: Yarn, device=None) -> torch.Tensor:
    """(dim / 2,) float32 inverse frequencies."""
    exps = torch.arange(0, y.dim, 2, dtype=torch.float32, device=device) / y.dim
    extra = 1.0 / (y.theta ** exps)
    inter = 1.0 / (y.factor * y.theta ** exps)
    low = max(math.floor(_correction_dim(y.beta_fast, y.dim, y.theta, y.original_max)), 0)
    high = min(math.ceil(_correction_dim(y.beta_slow, y.dim, y.theta, y.original_max)), y.dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(y.dim // 2, dtype=torch.float32, device=device) - low)
                       / (high - low), 0, 1)
    keep = 1.0 - ramp
    return inter * (1 - keep) + extra * keep


def table(y: Yarn, n_positions: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (n_positions, dim) float32."""
    t = torch.arange(n_positions, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq(y, device))
    emb = torch.cat([freqs, freqs], dim=-1)
    scale = mscale(y.factor, y.mscale) / mscale(y.factor, y.mscale_all_dim)
    return emb.cos() * scale, emb.sin() * scale


def apply(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` (..., dim) by ``cos`` / ``sin`` broadcast to it, in
    float32; the result in ``x``'s dtype."""
    d = x.shape[-1]
    xf = x.float().unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    rot = torch.cat([-xf[..., d // 2:], xf[..., :d // 2]], dim=-1)
    return (xf * cos + rot * sin).to(x.dtype)
