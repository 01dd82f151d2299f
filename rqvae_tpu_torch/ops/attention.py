"""Masked scaled dot-product attention (counterpart of rqvae_tpu/ops/attention.py).

``attend`` routes as the JAX one does, in its order (spans, short, big,
dense); each kernel route takes the hand-written CUDA kernels for CUDA
tensors and their plain twin on the CPU:

* span-restricted attention (``q_spans = (lo, hi, extra)``, the packed
  training masks, ``span_mask``): ``flash_attention_spans`` when Nq >= 256,
  Nk >= 256, Dh >= 64, not causal and no ``k_mask``, else the dense
  ``sdpa`` under the span mask. In packed training only the encoder's
  self-attention (808 x 808 at the ML-32M shape) takes the kernel;
* short: ``flash_attention_small`` when Nq < 256, Nk < 256, Dh >= 64 and the
  environment variable ``RQVAE_TPU_SHORT_FLASH`` is ``"1"`` (read at each
  call; the JAX package reads the same variable, so one setting drives
  both). It is off by default, as in JAX. With it on, every attention call
  of the Amazon model takes the kernel: the encoder's 81 x 81 under the key
  mask, the decoder's causal 5 x 5, the 5 x 81 cross-attention, and in
  beam search the 32 x 81 beam-folded cross queries and the decode step's
  1 x T self-attention;
* big: ``flash_attention`` when Nq >= 256, Nk >= 256 and Dh >= 64 (the
  801-token ML-32M encoder);
* everything else: the dense ``sdpa``.

One rule is the port's own (JAX's Pallas kernels take any width): every
kernel route also needs Dh <= ``FLASH_MAX_DH`` (128). The CUDA kernels stage
Dh-wide q / k / v / g tiles of 64 rows in shared memory, at most 227 KB a
block on an H100 (the fp32 dk / dv kernel's tiles take 166 KB at Dh = 128
and would take 297 KB at 256), and their wrappers raise on a wider head.
Wider heads (Dh = 256, say) take the dense ``sdpa`` under the same mask
``build_mask`` builds, the span mask included: the same function, so the
output equals JAX's kernel route to fp32 rounding. It is a route, not a
fallback: the kernels are never tried on such a shape.

The 256-token cut is the JAX package's, measured on a TPU v5e; it has not
been re-measured on the H100. Layout is (batch, seq, heads, head_dim)
throughout; the kernel routes see the operands as (B, H, N, Dh) views
through ``transpose(1, 2)``, which the kernels read by strides, so no copy
is made at this boundary.

``sdpa`` is written as the JAX one is, not with
``F.scaled_dot_product_attention``: scores in fp32 (q and k upcast, the
counterpart of ``preferred_element_type=float32``), fp32 softmax,
probabilities cast to ``v.dtype`` before the PV product, and fully masked
rows give zeros, not NaN.
"""
from __future__ import annotations

import math
import os
from typing import Optional

import torch

from rqvae_tpu_torch.ops.flash_attention import (
    MAX_DH,
    flash_attention,
    flash_attention_plain,
    flash_attention_small,
    flash_attention_small_plain,
    flash_attention_spans,
    flash_attention_spans_plain,
    span_mask,
)

NEG_INF = -1e30
FLASH_MIN_LEN = 256   # the JAX package's cut (Nq and Nk), with Dh >= 64
FLASH_MIN_DH = 64
FLASH_MAX_DH = MAX_DH  # the port's rule: wider heads go dense (the module docstring says why)
SHORT_FLASH_ENV = "RQVAE_TPU_SHORT_FLASH"   # "1": shorter shapes take flash_attention_small


def build_mask(q_len: int, k_len: int, *, causal: bool = False,
               k_mask: Optional[torch.Tensor] = None,
               q_spans: Optional[tuple] = None,
               device=None) -> Optional[torch.Tensor]:
    """(B or 1, 1, Nq, Nk) boolean attention mask; True = attend.
    ``k_mask`` (B, Nk) bool; ``q_spans`` as ``span_mask``."""
    mask = None
    if causal:
        mask = torch.tril(torch.ones((q_len, k_len), dtype=torch.bool, device=device))[None, None]
    if k_mask is not None:
        km = k_mask[:, None, None, :]
        mask = km if mask is None else mask & km
    if q_spans is not None:
        sm = span_mask(q_spans, k_len)[:, None]
        mask = sm if mask is None else mask & sm
    return mask


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over (B, N, H, Dh) operands."""
    dh = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores * (1.0 / math.sqrt(dh))
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    if mask is not None:
        probs = torch.where(torch.any(mask, dim=-1, keepdim=True), probs, 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = False,
           k_mask: Optional[torch.Tensor] = None,
           q_spans: Optional[tuple] = None) -> torch.Tensor:
    """Structured-mask attention entry point used by the transformer.
    ``k_mask`` (B, Nk) bool, True = attend; ``q_spans`` (lo, hi, extra),
    each (B, Nq) int. Routes as the module docstring says; a head wider than
    ``FLASH_MAX_DH`` always takes the dense ``sdpa``."""
    kernel_dh = FLASH_MIN_DH <= q.shape[-1] <= FLASH_MAX_DH
    big = q.shape[1] >= FLASH_MIN_LEN and k.shape[1] >= FLASH_MIN_LEN and kernel_dh
    on_card = q.device.type == "cuda"
    if q_spans is not None:
        if big and not causal and k_mask is None:
            fn = flash_attention_spans if on_card else flash_attention_spans_plain
            return fn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                      *q_spans).transpose(1, 2)
        mask = build_mask(q.shape[1], k.shape[1], causal=causal, k_mask=k_mask,
                          q_spans=q_spans, device=q.device)
        return sdpa(q, k, v, mask)
    short = (q.shape[1] < FLASH_MIN_LEN and k.shape[1] < FLASH_MIN_LEN and kernel_dh
             and os.environ.get(SHORT_FLASH_ENV, "0") == "1")
    if short or big:
        qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        if short:
            fn = flash_attention_small if on_card else flash_attention_small_plain
        else:
            fn = flash_attention if on_card else flash_attention_plain
        return fn(qh, kh, vh, k_mask=k_mask, causal=causal).transpose(1, 2)
    mask = build_mask(q.shape[1], k.shape[1], causal=causal, k_mask=k_mask, device=q.device)
    return sdpa(q, k, v, mask)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, N, H*Dh) -> (B, N, H, Dh)."""
    b, n, d = x.shape
    return x.reshape(b, n, num_heads, d // num_heads)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, N, H, Dh) -> (B, N, H*Dh)."""
    b, n, h, dh = x.shape
    return x.reshape(b, n, h * dh)
