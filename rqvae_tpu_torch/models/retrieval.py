"""Encoder-decoder generative-retrieval model over semantic-ID sequences
(counterpart of rqvae_tpu/models/retrieval.py).

Embedding sum: level-offset sem-ID table + learned absolute positions over
flat token positions, with the user's hash-bucket token prepended to the
history; the future side is a learned BOS then fut + token-type embeddings;
RMSNorm then an input projection to the attention width on both streams.
In training, ``input_dropout`` applies to both normalised streams and the
transformer's own dropout inside it, all drawn from one ``torch.Generator``.
``forward_packed`` is the packed-training forward: several user segments a
row, attention made segment-local by per-query key spans.

Under tensor parallelism (``parallel/tensor``; JAX's ``tp_param_shardings``)
the sem-ID lookup is vocab-parallel (``models/embeddings``), ``in_proj`` and
``in_proj_context`` are column-parallel with their outputs gathered (the
residual stream and its RMSNorm need whole rows), the transformer runs the
rank's heads and FFN slice, and ``out_proj`` is row-parallel: the rank's
features of the whole decoder output times its rows, then one
``all_reduce`` of the logits. Every entry point below does this.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from rqvae_tpu_torch.data.schemas import TokenizedSeqBatch
from rqvae_tpu_torch.models import embeddings, transformer
from rqvae_tpu_torch.models.dropout import dropout as _dropout
from rqvae_tpu_torch.models.normalize import rms_norm, rms_norm_init
from rqvae_tpu_torch.models.transformer import TransformerConfig
from rqvae_tpu_torch.parallel import tensor as tp
from rqvae_tpu_torch.utils import initializers
from rqvae_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class RetrievalConfig:
    embedding_dim: int = 128
    attn_dim: int = 512
    dropout: float = 0.3
    num_heads: int = 8
    n_layers: int = 8              # encoder + decoder total; split in half
    num_embeddings: int = 256      # codebook size
    sem_id_dim: int = 4            # n_layers_rqvae + 1 (dedup dim)
    max_pos: int = 80              # max flat token positions (N * sem_id_dim)
    user_hash_buckets: int = 2000
    input_dropout: float = 0.5
    mlp_hidden_dim: int = 1024

    @property
    def transformer(self) -> TransformerConfig:
        return TransformerConfig(
            d_model=self.attn_dim, num_heads=self.num_heads, dropout=self.dropout,
            encoder_layers=self.n_layers // 2, decoder_layers=self.n_layers // 2,
            mlp_hidden_dim=self.mlp_hidden_dim,
        )


class ModelOutput(NamedTuple):
    loss: torch.Tensor     # scalar
    logits: torch.Tensor   # (B, D, K)
    loss_d: torch.Tensor   # (D,) per-position loss


def init(gen: torch.Generator, cfg: RetrievalConfig, *, device=None):
    """Random parameters with the JAX pytree layout; on ``cuda`` unless
    ``device`` says otherwise."""
    dev = resolve_device(device)
    e, a = cfg.embedding_dim, cfg.attn_dim
    return {
        "bos": initializers.uniform01(gen, (e,), device=dev),
        "norm": rms_norm_init(e, device=dev),
        "norm_cxt": rms_norm_init(e, device=dev),
        "sem_emb": embeddings.sem_id_embedder_init(gen, cfg.num_embeddings, cfg.sem_id_dim, e,
                                                   device=dev),
        "user_emb": embeddings.user_id_embedder_init(gen, cfg.user_hash_buckets, e, device=dev),
        "wpe": initializers.normal(gen, (cfg.max_pos, e), device=dev),
        "tte": initializers.normal(gen, (cfg.sem_id_dim, e), device=dev),
        "in_proj": initializers.linear(gen, e, a, device=dev),
        "in_proj_context": initializers.linear(gen, e, a, device=dev),
        "out_proj": initializers.linear(gen, a, cfg.num_embeddings, device=dev),
        "transformer": transformer.init(gen, cfg.transformer, device=dev),
    }


def _in_proj(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Column-parallel input projection, output gathered to whole rows."""
    return tp.gather_from_model(tp.copy_to_model(h) @ w.to(h.dtype))


def _logits(out: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Row-parallel output projection: the rank's features of ``out`` times
    its rows of ``w``, summed over the model group."""
    return tp.reduce_from_model(tp.scatter_to_model(out) @ w.to(out.dtype))


def embed_context(params, cfg: RetrievalConfig, batch: TokenizedSeqBatch):
    """History stream: [user token, wpe + sem-ID embeddings] and its mask."""
    b, n = batch.sem_ids.shape
    sem = embeddings.sem_id_embed(params["sem_emb"], batch.sem_ids, batch.token_type_ids,
                                  cfg.num_embeddings, batch.seq_mask)
    # positions past max_pos reuse the last row, as JAX's clamping gather does
    pos = torch.arange(n, device=sem.device).clamp(max=params["wpe"].shape[0] - 1)
    sem = sem + params["wpe"][pos][None, :, :]
    user = embeddings.user_id_embed(params["user_emb"], batch.user_ids)
    ctx = torch.cat([user[:, None, :], sem], dim=1)
    ones = torch.ones((b, 1), dtype=torch.bool, device=batch.seq_mask.device)
    return ctx, torch.cat([ones, batch.seq_mask], dim=1)


def _fut_embed(params, cfg: RetrievalConfig, sem_ids_fut, token_type_ids_fut):
    fut = embeddings.sem_id_embed(params["sem_emb"], sem_ids_fut, token_type_ids_fut,
                                  cfg.num_embeddings)
    return fut + F.embedding(token_type_ids_fut.long(), params["tte"])


def embed_future(params, cfg: RetrievalConfig, batch: TokenizedSeqBatch):
    """Target stream: [BOS, fut embedding + token-type embedding]."""
    b = batch.sem_ids.shape[0]
    bos = params["bos"].expand(b, 1, cfg.embedding_dim)
    if batch.sem_ids_fut is None:
        return bos
    return torch.cat([bos, _fut_embed(params, cfg, batch.sem_ids_fut,
                                      batch.token_type_ids_fut)], dim=1)


def predict(params, cfg: RetrievalConfig, batch: TokenizedSeqBatch, *, training: bool = False,
            generator: Optional[torch.Generator] = None, cached_context=None):
    """Shared trunk: embed, project, transform. Returns (decoder output
    (B, Nf, A), encoder context (B, Nc, A), context mask)."""
    ctx_emb, ctx_mask = embed_context(params, cfg, batch)
    fut_emb = embed_future(params, cfg, batch)
    h_ctx = _dropout(rms_norm(ctx_emb, params["norm"]), cfg.input_dropout, training, generator)
    h_fut = _dropout(rms_norm(fut_emb, params["norm_cxt"]), cfg.input_dropout, training,
                     generator)
    ctx_in = _in_proj(h_ctx, params["in_proj_context"])
    fut_in = _in_proj(h_fut, params["in_proj"])
    out, context = transformer.apply(params["transformer"], cfg.transformer, fut_in, ctx_in,
                                     ctx_mask, training=training, generator=generator,
                                     cached_context=cached_context)
    return out, context, ctx_mask


def cross_entropy_ignore(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-position CE, 0 where the target is -1 or outside [0, K)."""
    valid = (targets >= 0) & (targets < logits.shape[-1])
    safe = targets.long().clamp(0, logits.shape[-1] - 1)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return torch.where(valid, nll, 0.0)


def forward(params, cfg: RetrievalConfig, batch: TokenizedSeqBatch, *, training: bool = False,
            generator: Optional[torch.Generator] = None) -> ModelOutput:
    """Training / eval-loss forward: CE summed over the sem-ID tuple, meaned
    over the batch. ``training`` turns dropout on (``generator`` required)."""
    out, _, _ = predict(params, cfg, batch, training=training, generator=generator)
    logits = _logits(out, params["out_proj"])[:, :-1, :]
    unred = cross_entropy_ignore(logits, batch.sem_ids_fut)
    return ModelOutput(loss=torch.mean(torch.sum(unred, dim=1)), logits=logits,
                       loss_d=torch.mean(unred, dim=0))


# ---------------------------------------------------------------------------
# Packed training (data/packing.py): several user segments per row
# ---------------------------------------------------------------------------
# Token layout per row (R rows, S slots, N item capacity, D = sem_id_dim):
#   encoder: [user_0 .. user_{S-1}] ++ item tokens in (item, level) order
#            (Nc = S + N*D tokens; segment s's item tokens are contiguous)
#   decoder: S blocks of [BOS, fut_0 .. fut_{D-1}]  (Nf = S*(D+1) tokens)
# Attention is segment-local via per-query key spans (ops/attention.
# span_mask): window = own segment's item-token range, extra column = own
# user token. Per segment, embeddings, positions and loss are the flat
# model's.


def packed_spans(cfg: RetrievalConfig, tok):
    """The three span sets of a packed batch: (enc_spans, fut_self_spans,
    cross_spans), each a (lo, hi, extra) triple of (R, Nq) int32 tensors.
    Padding tokens and unused slots attend nothing (lo = hi = 0, extra = -1)."""
    r, s = tok.slot_valid.shape
    d = cfg.sem_id_dim
    dev = tok.seg_item.device
    item_seg = torch.repeat_interleave(tok.seg_item, d, dim=1)     # (R, N*D)
    lo_slot = s + tok.slot_start * d                               # (R, S) token lo
    hi_slot = lo_slot + tok.slot_len * d

    def window(seg):
        safe = seg.clamp(min=0).long()
        ok = seg >= 0
        return (torch.where(ok, torch.gather(lo_slot, 1, safe), 0),
                torch.where(ok, torch.gather(hi_slot, 1, safe), 0))

    # encoder self-attention: user tokens sit at columns 0..S-1, so a
    # token's extra column is its slot index
    slot_ids = torch.arange(s, dtype=torch.int32, device=dev)[None]
    user_seg = torch.where(tok.slot_valid, slot_ids, -1)           # (R, S)
    lo_u, hi_u = window(user_seg)
    lo_i, hi_i = window(item_seg)
    enc_spans = (torch.cat([lo_u, lo_i], dim=1), torch.cat([hi_u, hi_i], dim=1),
                 torch.cat([user_seg, item_seg], dim=1))

    # decoder side: slot s owns positions [s*(D+1), (s+1)*(D+1))
    nf = s * (d + 1)
    pos = torch.arange(nf, dtype=torch.int32, device=dev)
    slot_of_fut = pos // (d + 1)
    fut_self_spans = ((slot_of_fut * (d + 1)).expand(r, nf), (pos + 1).expand(r, nf),  # causal in-slot
                      torch.full((r, nf), -1, dtype=torch.int32, device=dev))
    fut_seg = torch.where(tok.slot_valid[:, slot_of_fut.long()], slot_of_fut[None], -1)
    lo_f, hi_f = window(fut_seg)
    return enc_spans, fut_self_spans, (lo_f, hi_f, fut_seg)


def embed_packed_context(params, cfg: RetrievalConfig, tok):
    """[S user tokens] ++ [wpe + sem-ID embeddings], positions restarting
    per segment (the flat ``embed_context`` per segment). Positions are a
    gather (``F.embedding``), where JAX multiplies by a one-hot matrix (a TPU
    idiom that keeps the backward off a scatter): the same values."""
    r = tok.sem_ids.shape[0]
    n = tok.seg_item.shape[1]
    d = cfg.sem_id_dim
    dev = tok.sem_ids.device
    sem = embeddings.sem_id_embed(params["sem_emb"], tok.sem_ids, tok.token_type_ids,
                                  cfg.num_embeddings, tok.seq_mask)
    seg_pos = torch.arange(n, device=dev)[None] - torch.gather(
        tok.slot_start, 1, tok.seg_item.clamp(min=0).long())      # (R, N)
    tok_pos = (torch.repeat_interleave(seg_pos, d, dim=1) * d
               + torch.arange(d, device=dev).repeat(n)[None])
    tok_pos = tok_pos.clamp(0, params["wpe"].shape[0] - 1)
    sem = sem + F.embedding(tok_pos.long(), params["wpe"]).to(sem.dtype)
    user = embeddings.user_id_embed(params["user_emb"], tok.user_ids)
    return torch.cat([user, sem], dim=1)                           # (R, S+N*D, E)


def embed_packed_future(params, cfg: RetrievalConfig, tok):
    """S blocks of [BOS, fut embedding + token-type embedding]."""
    r, s, d = tok.sem_ids_fut.shape
    e = cfg.embedding_dim
    tt = torch.arange(d, dtype=torch.int32, device=tok.sem_ids_fut.device).expand(r, s, d)
    fut = _fut_embed(params, cfg, tok.sem_ids_fut, tt)             # (R, S, D, E)
    bos = params["bos"].expand(r, s, 1, e)
    return torch.cat([bos, fut], dim=2).reshape(r, s * (d + 1), e)


def forward_packed(params, cfg: RetrievalConfig, tok, *, training: bool = False,
                   generator: Optional[torch.Generator] = None,
                   n_valid: Optional[torch.Tensor] = None) -> ModelOutput:
    """Training / eval-loss forward over a packed batch
    (``semids.PackedTokenizedBatch``): the CE summed over each slot's sem-ID
    tuple, meaned over the valid slots (the flat forward's loss over the
    examples the batch packed). ``n_valid`` is the count the loss is meaned
    over (default: this batch's valid slots; data parallelism passes the
    replicas' sum). ``training`` draws the input dropout, then the encoder's
    and the decoder's dropout, from ``generator`` in that order."""
    ctx_emb = embed_packed_context(params, cfg, tok)
    fut_emb = embed_packed_future(params, cfg, tok)
    h_ctx = _dropout(rms_norm(ctx_emb, params["norm"]), cfg.input_dropout, training, generator)
    h_fut = _dropout(rms_norm(fut_emb, params["norm_cxt"]), cfg.input_dropout, training,
                     generator)
    ctx_in = _in_proj(h_ctx, params["in_proj_context"])
    fut_in = _in_proj(h_fut, params["in_proj"])
    enc_spans, fut_self_spans, cross_spans = packed_spans(cfg, tok)
    context = transformer.encode(params["transformer"], cfg.transformer, ctx_in, None,
                                 training=training, generator=generator, self_spans=enc_spans)
    out = transformer.decode(params["transformer"], cfg.transformer, fut_in, context, None,
                             training=training, generator=generator,
                             self_spans=fut_self_spans, cross_spans=cross_spans)
    logits = _logits(out, params["out_proj"])                     # (R, S*(D+1), K)
    r, s, d = tok.sem_ids_fut.shape
    logits = logits.reshape(r, s, d + 1, -1)[:, :, :d]             # predict 0..D-1
    targets = torch.where(tok.slot_valid[:, :, None], tok.sem_ids_fut, -1)
    unred = cross_entropy_ignore(logits, targets)                  # (R, S, D)
    if n_valid is None:
        n_valid = torch.sum(tok.slot_valid)
    n_valid = torch.clamp(n_valid, min=1).float()
    return ModelOutput(loss=torch.sum(unred) / n_valid, logits=logits,
                       loss_d=torch.sum(unred, dim=(0, 1)) / n_valid)


class GenerationCache(NamedTuple):
    """Per-batch-row beam-search state: every decoder block's cross K/V
    (computed once from the encoder output) and the encoder key mask."""

    kv: tuple                  # transformer.cross_kv output, entries (B, Nc, H, Dh)
    ctx_mask: torch.Tensor     # (B, Nc) bool


def encode_for_generation(params, cfg: RetrievalConfig,
                          batch: TokenizedSeqBatch) -> GenerationCache:
    """Run the encoder once and cache cross-attention K/V per decoder block."""
    ctx_emb, ctx_mask = embed_context(params, cfg, batch)
    h_ctx = rms_norm(ctx_emb, params["norm"])
    ctx_in = _in_proj(h_ctx, params["in_proj_context"])
    context = transformer.encode(params["transformer"], cfg.transformer, ctx_in, ctx_mask)
    kv = transformer.cross_kv(params["transformer"], cfg.transformer, context)
    return GenerationCache(kv=tuple(kv), ctx_mask=ctx_mask)


def forward_generate_cached(params, cfg: RetrievalConfig, cache: GenerationCache,
                            sem_ids_fut: Optional[torch.Tensor],
                            token_type_ids_fut: Optional[torch.Tensor], *,
                            beams: int, n_rows: int) -> torch.Tensor:
    """Logits (n_rows, K) at the last fut position, reprocessing the whole
    prefix against the cached cross K/V: the reference for the fast path."""
    bos = params["bos"].expand(n_rows, 1, cfg.embedding_dim)
    if sem_ids_fut is None:
        fut_emb = bos
    else:
        fut_emb = torch.cat([bos, _fut_embed(params, cfg, sem_ids_fut, token_type_ids_fut)],
                            dim=1)
    h_fut = rms_norm(fut_emb, params["norm_cxt"])
    fut_in = _in_proj(h_fut, params["in_proj"])
    out = transformer.decode_with_kv(params["transformer"], cfg.transformer, fut_in,
                                     cache.kv, cache.ctx_mask, beams=beams)
    return _logits(out[:, -1, :], params["out_proj"])


def decode_token_cached(params, cfg: RetrievalConfig, cache: GenerationCache, self_kv,
                        token_ids: Optional[torch.Tensor], token_type: int, *,
                        beams: int, n_rows: int):
    """Single-token generation step: embeds only the newest fut token
    (``None`` = BOS) and decodes it against both caches.
    Returns (logits (n_rows, K), new self_kv)."""
    if token_ids is None:
        emb = params["bos"].expand(n_rows, 1, cfg.embedding_dim)
    else:
        tt = torch.full((n_rows, 1), token_type, dtype=torch.int32, device=token_ids.device)
        emb = _fut_embed(params, cfg, token_ids[:, None], tt)
    h = rms_norm(emb, params["norm_cxt"])
    x_in = _in_proj(h, params["in_proj"])
    out, self_kv = transformer.decode_step_with_kv(params["transformer"], cfg.transformer, x_in,
                                                   self_kv, cache.kv, cache.ctx_mask, beams=beams)
    return _logits(out[:, -1, :], params["out_proj"]), self_kv
