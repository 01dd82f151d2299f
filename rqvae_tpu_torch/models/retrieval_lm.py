"""Decoder-only generative retrieval over semantic IDs on DeepSeek-V2's
block: multi-head latent attention (``models/mla``) and a routed-plus-shared
expert layer after leading dense layers (``models/moe``).

A user's sequence is ``[user token, the history's semantic-ID tokens]`` at
positions 0 .. n - 1 (padding never takes a position); the next item's
level-0 logits come from position n - 1, and the generated tokens take
positions n, n + 1, ..., each embedded with its level's offset row of the
semantic-ID table (``embeddings.sem_id_embed``). The user token is the
user's hash bucket row (``embeddings.user_id_embed``). Each layer is
``h = x + MLA(rms(x))``, ``x = h + FFN(rms(h))``; then a final RMSNorm and
a head over the codebook shared by the levels.

Serving (``models/generation``): ``prefill`` runs the histories once and
leaves each layer's latent cache of the history, one row a user, which the
user's beams share; ``decode_step`` runs one token a beam row through the
absorbed attention against that cache and the beams' own latent cache,
which ``reorder`` follows by beam parent after each top-k.

Parameters (weights laid out (in, out)): ``sem_emb`` (the level-offset
table, padding rows zero), ``user_emb``, ``final_norm``, ``head`` and
``layers``, each with ``attn_norm``, ``wq``, ``wkv_a``, ``kv_norm``,
``wkv_b``, ``wo``, ``ffn_norm`` and either ``mlp`` (``gate_up``, ``down``)
for the dense layers or ``moe`` (``router``, ``experts_gate_up`` (E, hidden,
2 F), ``experts_down`` (E, F, hidden), ``shared_gate_up``, ``shared_down``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from rqvae_tpu_torch.data.schemas import TokenizedSeqBatch
from rqvae_tpu_torch.models import embeddings, mla, moe, rope
from rqvae_tpu_torch.models.normalize import rms_norm
from rqvae_tpu_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class RetrievalLMConfig:
    """What the forward reads besides the weights, whose shapes give the
    hidden size, the depth, each layer's kind (dense or experts) and the
    experts' count and width."""

    num_heads: int = 16
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128
    kv_rank: int = 512
    top_k: int = 6
    routed_scaling: float = 1.0
    eps: float = 1e-6
    yarn: rope.Yarn = rope.Yarn(64, 10000.0, 40.0, 4096, 32.0, 1.0, 0.707, 0.707)
    num_embeddings: int = 256        # codebook size, the head's width
    sem_id_dim: int = 4              # levels + the dedup column


# DeepSeek-V2 settings this model implements in one way only
_FIXED = {"scoring_func": "softmax", "topk_method": "greedy", "norm_topk_prob": False,
          "q_lora_rank": None, "hidden_act": "silu", "moe_layer_freq": 1, "n_group": 1,
          "topk_group": 1, "attention_bias": False}


def config_from_deepseek(c: dict, *, num_heads: int, num_embeddings: int,
                         sem_id_dim: int) -> RetrievalLMConfig:
    """The model of a DeepSeek-V2 ``config.json``'s keys ``c`` with
    ``num_heads`` heads, over a semantic-ID vocabulary."""
    for key, want in _FIXED.items():
        if c.get(key, want) != want:
            raise ValueError(f"{key}={c[key]!r} is not supported (only {want!r})")
    rs = c["rope_scaling"]
    if rs.get("type") != "yarn":
        raise ValueError(f"rope_scaling type {rs.get('type')!r} is not supported (only yarn)")
    return RetrievalLMConfig(
        num_heads=num_heads, qk_nope_dim=int(c["qk_nope_head_dim"]),
        qk_rope_dim=int(c["qk_rope_head_dim"]), v_dim=int(c["v_head_dim"]),
        kv_rank=int(c["kv_lora_rank"]), top_k=int(c["num_experts_per_tok"]),
        routed_scaling=float(c["routed_scaling_factor"]), eps=float(c["rms_norm_eps"]),
        yarn=rope.Yarn(int(c["qk_rope_head_dim"]), float(c["rope_theta"]), float(rs["factor"]),
                       int(rs["original_max_position_embeddings"]), float(rs["beta_fast"]),
                       float(rs["beta_slow"]), float(rs["mscale"]), float(rs["mscale_all_dim"])),
        num_embeddings=num_embeddings, sem_id_dim=sem_id_dim)


class HistoryCache(NamedTuple):
    """What ``prefill`` leaves for the decode steps, one row a user."""

    kv: Tuple[torch.Tensor, ...]   # per layer (B, N, kv_rank + rope): [rms(c), k_pe], left-aligned
    valid: torch.Tensor            # (B, N) bool
    lengths: torch.Tensor          # (B,) int64: n, the sequence's tokens
    tokens: int                    # sum of lengths (host)
    cos: torch.Tensor              # (N + sem_id_dim, rope) float32 rotary table
    sin: torch.Tensor


def _ffn(lp, cfg: RetrievalLMConfig, x: torch.Tensor, routes: Optional[list]) -> torch.Tensor:
    h = rms_norm(x, lp["ffn_norm"], cfg.eps)
    return moe.dense(lp["mlp"], h) if "mlp" in lp else moe.experts_layer(lp["moe"], cfg, h, routes)


def _head(params, cfg: RetrievalLMConfig, x: torch.Tensor) -> torch.Tensor:
    return rms_norm(x, params["final_norm"], cfg.eps) @ params["head"]


def prefill(params, cfg: RetrievalLMConfig, batch: TokenizedSeqBatch,
            routes: Optional[list] = None) -> Tuple[torch.Tensor, HistoryCache]:
    """(level-0 logits (B, K) at each user's last token, the history
    cache). Only the valid tokens run (packed); one host synchronisation
    finds them. ``routes``, if given, gets each expert layer's (T, top_k)
    experts of the valid tokens, user by user."""
    b = batch.sem_ids.shape[0]
    n = batch.sem_ids.shape[1] + 1
    dev = batch.sem_ids.device
    slots = torch.cat([torch.ones((b, 1), dtype=torch.bool, device=dev), batch.seq_mask], dim=1)
    src = slots.flatten().nonzero().squeeze(1)
    pos = (torch.cumsum(slots, dim=1) - 1).flatten()[src]
    dst = (src // n) * n + pos                      # left-aligned: a token's slot is its position
    lengths = slots.sum(dim=1)
    sem = embeddings.sem_id_embed(params["sem_emb"], batch.sem_ids, batch.token_type_ids,
                                  cfg.num_embeddings, batch.seq_mask)
    user = embeddings.user_id_embed(params["user_emb"], batch.user_ids)
    x = torch.cat([user[:, None], sem], dim=1).flatten(0, 1)[src]
    cos, sin = rope.table(cfg.yarn, n + cfg.sem_id_dim, dev)
    kv = []
    for lp in params["layers"]:
        a, cache = mla.prefill(lp, cfg, x, dst, b, n, cos[pos], sin[pos])
        x = x + a
        x = x + _ffn(lp, cfg, x, routes)
        kv.append(cache)
    last = torch.cumsum(lengths, dim=0) - 1
    valid = torch.arange(n, device=dev)[None] < lengths[:, None]
    return _head(params, cfg, x[last]), HistoryCache(tuple(kv), valid, lengths, int(src.numel()),
                                                      cos, sin)


def decode_positions(hist: HistoryCache, level: int, beams: int) -> torch.Tensor:
    """(B * beams,) positions of the level-``level`` token of each beam row."""
    return (hist.lengths + level).repeat_interleave(beams)


def decode_step(params, cfg: RetrievalLMConfig, hist: HistoryCache,
                own: Optional[Tuple[torch.Tensor, ...]], tokens: torch.Tensor, level: int):
    """One token a beam row: ``tokens`` (R,) of level ``level``, R = B *
    beams rows in (user, beam) order, after the rows' ``own`` latent caches
    (None before the first). Returns (logits (R, K), the own caches with
    this token appended)."""
    r = tokens.shape[0]
    beams = r // hist.valid.shape[0]
    levels = torch.full((r, 1), level, dtype=torch.int32, device=tokens.device)
    x = embeddings.sem_id_embed(params["sem_emb"], tokens[:, None], levels,
                                cfg.num_embeddings)[:, 0]
    pos = decode_positions(hist, level, beams)
    cos, sin = hist.cos[pos], hist.sin[pos]
    if profiling.enabled():
        profiling.count("mla.cache_tokens", len(params["layers"]) * (hist.tokens + r * (level + 1)))
    out = []
    for i, lp in enumerate(params["layers"]):
        a, o = mla.decode(lp, cfg, x, cos, sin, hist.kv[i], hist.valid,
                          None if own is None else own[i])
        x = x + a
        x = x + _ffn(lp, cfg, x, None)
        out.append(o)
    return _head(params, cfg, x), tuple(out)


def reorder(own: Tuple[torch.Tensor, ...], rows: torch.Tensor, parent: torch.Tensor):
    """Each surviving beam row takes its parent's own cache; ``rows`` (B, 1)
    and ``parent`` (B, k) as the beam loop has them."""
    b, k = parent.shape
    return tuple(c.view(b, k, *c.shape[1:])[rows, parent].reshape(c.shape) for c in own)
