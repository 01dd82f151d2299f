"""Multi-head latent attention (DeepSeek-V2's ``DeepseekV2Attention`` with
no query compression), for the decoder-only retrieval model
(``models/retrieval_lm``).

Per token ``h``: ``q = h W_q`` (heads x (nope + rope)); ``[c, k_pe] = h
W_kva`` with ``c <- rms(c)`` the latent (``kv_rank`` wide) and ``k_pe`` one
rotary key shared by the heads; ``[k_nope, v] = c W_kvb`` (heads x (nope +
v)). RoPE (``models/rope``) goes on ``q_pe`` and ``k_pe``. Scores are ``q .
[k_nope, k_pe]`` times ``(nope + rope)^-0.5 mscale^2``, softmax in float32,
``o = concat_heads(p v) W_o``.

``prefill`` runs a user's tokens at once in the decompressed form: the
tokens come packed (only the valid ones), are scattered into the (B, N)
layout for a causal SDPA (histories are left-aligned, so causality alone
keeps every valid query off the padding) and gathered back. It returns
the layer's latent cache, ``[rms(c), k_pe]`` (``kv_rank + rope`` values a
token) in the (B, N) layout.

``decode`` runs one new token a beam row in the absorbed form: ``W_kvb``'s
key part is folded into the query (``q_lat = q_nope W_k^T``, ``kv_rank``
wide), the scores are taken against the latent cache itself, of the
history (B rows, each shared by its ``beams`` beam rows, padding masked)
and of the beam's own tokens (one row a beam, this token last), and
``W_kvb``'s value part is applied after the weighted sum.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from rqvae_tpu_torch.models import rope
from rqvae_tpu_torch.models.normalize import rms_norm
from rqvae_tpu_torch.utils import profiling


def softmax_scale(cfg) -> float:
    return ((cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
            * rope.mscale(cfg.yarn.factor, cfg.yarn.mscale_all_dim) ** 2)


def _project(p, cfg, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """(q_nope (T, H, nope), q_pe (T, H, rope) rotated, latent entry (T,
    kv_rank + rope)) of tokens ``x`` (T, hidden) at the rows of cos / sin."""
    h = rms_norm(x, p["attn_norm"], cfg.eps)
    q = (h @ p["wq"]).unflatten(-1, (cfg.num_heads, cfg.qk_nope_dim + cfg.qk_rope_dim))
    q_nope, q_pe = q.split([cfg.qk_nope_dim, cfg.qk_rope_dim], dim=-1)
    c, k_pe = (h @ p["wkv_a"]).split([cfg.kv_rank, cfg.qk_rope_dim], dim=-1)
    c = rms_norm(c, p["kv_norm"], cfg.eps)
    q_pe = rope.apply(q_pe, cos[:, None], sin[:, None])
    k_pe = rope.apply(k_pe, cos, sin)
    return q_nope, q_pe, torch.cat([c, k_pe], dim=-1)


def _kv_b(p, cfg) -> torch.Tensor:
    """W_kvb as (kv_rank, heads, nope + v)."""
    return p["wkv_b"].view(cfg.kv_rank, cfg.num_heads, cfg.qk_nope_dim + cfg.v_dim)


def prefill(p, cfg, x: torch.Tensor, flat_idx: torch.Tensor, b: int, n: int, cos: torch.Tensor,
            sin: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(attention output (T, hidden), latent cache (B, N, kv_rank + rope))
    of the packed tokens ``x`` (T, hidden) sitting at ``flat_idx`` of the
    (B, N) layout; ``cos`` / ``sin`` (T, rope) at their positions."""
    with profiling.span("mla.prefill"):
        t, heads = x.shape[0], cfg.num_heads
        q_nope, q_pe, entry = _project(p, cfg, x, cos, sin)
        cache = x.new_zeros((b * n, entry.shape[-1])).index_copy_(0, flat_idx, entry)
        c, k_pe = entry.split([cfg.kv_rank, cfg.qk_rope_dim], dim=-1)
        k_nope, v = (c @ p["wkv_b"]).unflatten(-1, (heads, -1)).split(
            [cfg.qk_nope_dim, cfg.v_dim], dim=-1)
        q = torch.cat([q_nope, q_pe], dim=-1)
        k = torch.cat([k_nope, k_pe[:, None].expand(t, heads, cfg.qk_rope_dim)], dim=-1)

        def padded(z):   # (T, heads, d) -> (B, heads, N, d), zeros at the padding
            out = z.new_zeros((b * n,) + z.shape[1:]).index_copy_(0, flat_idx, z)
            return out.view(b, n, heads, -1).transpose(1, 2)

        o = F.scaled_dot_product_attention(padded(q), padded(k), padded(v), is_causal=True,
                                           scale=softmax_scale(cfg))
        o = o.transpose(1, 2).reshape(b * n, heads * cfg.v_dim).index_select(0, flat_idx)
        return o @ p["wo"], cache.view(b, n, -1)


def decode(p, cfg, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, hist: torch.Tensor,
           hist_valid: torch.Tensor, own: Optional[torch.Tensor]):
    """(attention output (R, hidden), the beams' own latent cache (R, j,
    kv_rank + rope) with this token appended) for one new token a beam row,
    ``x`` (R, hidden), R = B * beams rows in (user, beam) order; ``hist``
    (B, N, kv_rank + rope) the history's latent cache and ``hist_valid`` (B,
    N) its valid slots."""
    with profiling.span("mla.decode"):
        r, heads, rank = x.shape[0], cfg.num_heads, cfg.kv_rank
        b, n = hist_valid.shape
        beams = r // b
        q_nope, q_pe, entry = _project(p, cfg, x, cos, sin)
        own = entry[:, None] if own is None else torch.cat([own, entry[:, None]], dim=1)
        w = _kv_b(p, cfg)
        q_lat = torch.einsum("rhd,chd->rhc", q_nope, w[..., :cfg.qk_nope_dim])   # (R, H, rank)

        def scores(q_lat, q_pe, cache):   # q . [c, k_pe], the two parts summed in the product
            t = lambda z: z.transpose(1, 2)  # noqa: E731
            return torch.baddbmm(q_pe @ t(cache[..., rank:]), q_lat, t(cache[..., :rank]))

        s_hist = scores(q_lat.reshape(b, beams * heads, rank), q_pe.reshape(b, beams * heads, -1),
                        hist).view(b, beams, heads, n).masked_fill(~hist_valid[:, None, None, :],
                                                                   float("-inf"))
        s_own = scores(q_lat, q_pe, own)                                   # (R, H, j)
        s = torch.cat([s_hist.view(r, heads, n), s_own], dim=-1).float() * softmax_scale(cfg)
        a = torch.softmax(s, dim=-1).to(x.dtype)
        o_lat = (torch.matmul(a[..., :n].reshape(b, beams * heads, n), hist[..., :rank]).view(
            r, heads, rank) + torch.matmul(a[..., n:], own[..., :rank]))
        o = torch.einsum("rhc,chd->rhd", o_lat, w[..., cfg.qk_nope_dim:])
        return o.reshape(r, heads * cfg.v_dim) @ p["wo"], own
