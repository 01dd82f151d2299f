"""Pre-RMSNorm encoder-decoder transformer (counterpart of
rqvae_tpu/models/transformer.py), eval mode (no dropout).

Block: x + selfattn(rmsnorm(x)); decoder blocks add cross-attention whose
query reads rmsnorm of the BLOCK INPUT x, not of the self-attention output
(a quirk of the original model kept for parity); then out = a + mlp(rmsnorm(a)).
Fused qkv projection for self-attention, separate q / kv for cross; no bias.
In training (``training=True`` with a ``torch.Generator``) dropout applies
where the JAX package puts it: after ``attn_norm``, after
``cross_attn_norm``, inside the FFN and after the FFN.

Under tensor parallelism (``parallel/tensor``) each rank holds its heads'
columns of ``wqkv`` / ``wq`` / ``wkv`` and their rows of ``proj``: every
entry point computes H / m heads (the attention kernels see only those, and
the generation caches hold only those), copies the whole input of each
column-parallel projection to the model group and all-reduces each
row-parallel output, the FFN likewise (``models/mlp``). The decoder's
context is copied once for all its cross-attention blocks.

Heads that do not divide over the model axis (``tp.heads_split`` false: 6
heads on 4 ranks) keep every attention leaf whole on every rank
(``parallel/mesh.leaf_spec``) and each rank computes all H heads, the
kernels and the generation caches included; the FFN, the embeddings and the
projections around the transformer keep their Megatron layout. JAX takes the
same layout there (its ``attend`` sends such heads to the dense ``sdpa`` on
replicated weights); the port keeps the kernel routes. Such attention takes
its input without ``copy_to_model`` (whose backward would all-reduce a dx
every rank already holds whole, scaling it by m) and returns its output
without ``reduce_from_model`` (which would sum m whole outputs); its
weights' gradients are whole and equal on every rank of a model group.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from rqvae_tpu_torch.models import mlp
from rqvae_tpu_torch.models.dropout import dropout as _dropout
from rqvae_tpu_torch.models.normalize import rms_norm, rms_norm_init
from rqvae_tpu_torch.ops import attention as attn_ops
from rqvae_tpu_torch.parallel import tensor as tp
from rqvae_tpu_torch.utils import initializers
from rqvae_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    d_model: int
    num_heads: int
    dropout: float = 0.0
    encoder_layers: int = 4
    decoder_layers: int = 4
    mlp_hidden_dim: int = 1024

    def __post_init__(self):
        if self.d_model % self.num_heads:
            raise ValueError("d_model % num_heads != 0")


def _attn_init(gen, d_model: int, cross: bool, device):
    lin = lambda i, o: initializers.linear(gen, i, o, device=device)  # noqa: E731
    if cross:
        return {"wq": lin(d_model, d_model), "wkv": lin(d_model, 2 * d_model),
                "proj": lin(d_model, d_model)}
    return {"wqkv": lin(d_model, 3 * d_model), "proj": lin(d_model, d_model)}


def _block_init(gen, cfg: TransformerConfig, cross: bool, device):
    params = {
        "attn": _attn_init(gen, cfg.d_model, False, device),
        "attn_norm": rms_norm_init(cfg.d_model, device=device),
        "ff_norm": rms_norm_init(cfg.d_model, device=device),
        "ff_mlp": mlp.init(gen, cfg.d_model, (cfg.mlp_hidden_dim,), cfg.d_model, device=device),
    }
    if cross:
        params["cross_attn"] = _attn_init(gen, cfg.d_model, True, device)
        params["cross_attn_norm"] = rms_norm_init(cfg.d_model, device=device)
    return params


def init(gen: torch.Generator, cfg: TransformerConfig, *, device=None):
    device = resolve_device(device)
    return {
        "encoder": [_block_init(gen, cfg, False, device) for _ in range(cfg.encoder_layers)],
        "decoder": [_block_init(gen, cfg, True, device) for _ in range(cfg.decoder_layers)],
    }


def _to_heads(x, num_heads):
    """The input of a column-parallel attention projection: copied to the
    model group when the heads split over it, as it is when they stay whole."""
    return tp.copy_to_model(x) if tp.heads_split(num_heads) else x


def _out_proj(p, out, dtype, num_heads):
    """The output projection of the local heads: row-parallel and reduced
    when the heads split, whole otherwise."""
    y = attn_ops.merge_heads(out) @ p["proj"].to(dtype)
    return tp.reduce_from_model(y) if tp.heads_split(num_heads) else y


def _self_attention(p, x, num_heads, *, causal, k_mask, q_spans=None):
    heads = tp.local_heads(num_heads)
    q, k, v = torch.chunk(_to_heads(x, num_heads) @ p["wqkv"].to(x.dtype), 3, dim=-1)
    out = attn_ops.attend(
        attn_ops.split_heads(q, heads), attn_ops.split_heads(k, heads),
        attn_ops.split_heads(v, heads), causal=causal, k_mask=k_mask, q_spans=q_spans,
    )
    return _out_proj(p, out, x.dtype, num_heads)


def _cross_attention(p, x, context, num_heads, *, k_mask, q_spans=None):
    """``context`` is already copied to the model group (``decode``)."""
    heads = tp.local_heads(num_heads)
    q = _to_heads(x, num_heads) @ p["wq"].to(x.dtype)
    k, v = torch.chunk(context @ p["wkv"].to(x.dtype), 2, dim=-1)
    out = attn_ops.attend(
        attn_ops.split_heads(q, heads), attn_ops.split_heads(k, heads),
        attn_ops.split_heads(v, heads), causal=False, k_mask=k_mask, q_spans=q_spans,
    )
    return _out_proj(p, out, x.dtype, num_heads)


def _block_apply(p, cfg: TransformerConfig, x, *, causal: bool, self_k_mask=None,
                 context=None, cross_k_mask=None, training: bool = False,
                 generator: Optional[torch.Generator] = None, self_spans=None, cross_spans=None):
    drop = lambda t: _dropout(t, cfg.dropout, training, generator)  # noqa: E731
    attn_out = x + _self_attention(p["attn"], drop(rms_norm(x, p["attn_norm"])), cfg.num_heads,
                                   causal=causal, k_mask=self_k_mask, q_spans=self_spans)
    if context is not None:
        # quirk parity: the cross query reads the BLOCK INPUT x, not attn_out
        attn_out = attn_out + _cross_attention(
            p["cross_attn"], drop(rms_norm(x, p["cross_attn_norm"])), context, cfg.num_heads,
            k_mask=cross_k_mask, q_spans=cross_spans,
        )
    ff = mlp.apply(p["ff_mlp"], rms_norm(attn_out, p["ff_norm"]), dropout=cfg.dropout,
                   training=training, generator=generator)
    return attn_out + drop(ff)


def encode(params, cfg: TransformerConfig, context_in: torch.Tensor,
           context_mask: Optional[torch.Tensor], *, training: bool = False,
           generator: Optional[torch.Generator] = None, self_spans=None) -> torch.Tensor:
    """Non-causal self-attention stack over the history (B, Nc, d_model).
    ``self_spans`` (packed training) replaces the key mask with per-query
    key windows."""
    x = context_in
    for block in params["encoder"]:
        x = _block_apply(block, cfg, x, causal=False,
                         self_k_mask=None if self_spans is not None else context_mask,
                         training=training, generator=generator, self_spans=self_spans)
    return x


def decode(params, cfg: TransformerConfig, x: torch.Tensor, context: torch.Tensor,
           context_mask: Optional[torch.Tensor], *, training: bool = False,
           generator: Optional[torch.Generator] = None, self_spans=None,
           cross_spans=None) -> torch.Tensor:
    """Causal self-attention + cross-attention to the encoder output. Packed
    training passes ``self_spans`` (causality within a segment as hi = own
    position + 1) and ``cross_spans`` (the segment's encoder window) in place
    of plain causality and the key mask."""
    context = _to_heads(context, cfg.num_heads)
    for block in params["decoder"]:
        x = _block_apply(block, cfg, x, causal=self_spans is None, context=context,
                         cross_k_mask=None if cross_spans is not None else context_mask,
                         training=training, generator=generator, self_spans=self_spans,
                         cross_spans=cross_spans)
    return x


def apply(params, cfg: TransformerConfig, x, context_in, context_mask, *,
          training: bool = False, generator: Optional[torch.Generator] = None,
          cached_context=None):
    """Full encoder-decoder pass; ``cached_context`` skips the encoder.
    Returns (decoder output, encoder context)."""
    if cached_context is None:
        context = encode(params, cfg, context_in, context_mask, training=training,
                         generator=generator)
    else:
        context = cached_context
    return decode(params, cfg, x, context, context_mask, training=training,
                  generator=generator), context


def cross_kv(params, cfg: TransformerConfig, context: torch.Tensor):
    """Every decoder block's cross-attention (k, v), each (B, Nc, H, Dh)
    (``tp.local_heads``: H / m under tensor parallelism, H when the heads
    do not divide), computed once from the encoder output: the generation
    loop's cache."""
    heads = tp.local_heads(cfg.num_heads)
    out = []
    for block in params["decoder"]:
        k, v = torch.chunk(context @ block["cross_attn"]["wkv"].to(context.dtype), 2, dim=-1)
        out.append((attn_ops.split_heads(k, heads), attn_ops.split_heads(v, heads)))
    return out


def _fold_beams(x: torch.Tensor, beams: int) -> torch.Tensor:
    """(B*beams, Nf, H, Dh) -> (B, beams*Nf, H, Dh): a row's beams share its
    cross K/V, so they ride the query axis of one attention call."""
    bk, nf, h, dh = x.shape
    return x.reshape(bk // beams, beams * nf, h, dh)


def _unfold_beams(x: torch.Tensor, beams: int) -> torch.Tensor:
    b, bn, h, dh = x.shape
    return x.reshape(b * beams, bn // beams, h, dh)


def _cross_from_cache(block, hc, ck, cv, context_mask, num_heads, beams, dtype):
    p = block["cross_attn"]
    heads = tp.local_heads(num_heads)
    qf = _fold_beams(attn_ops.split_heads(hc @ p["wq"].to(hc.dtype), heads), beams)
    of = attn_ops.attend(qf, ck, cv, causal=False, k_mask=context_mask)
    return _out_proj(p, _unfold_beams(of, beams), dtype, num_heads)


def decode_with_kv(params, cfg: TransformerConfig, x: torch.Tensor, kv,
                   context_mask: torch.Tensor, *, beams: int = 1) -> torch.Tensor:
    """Full-prefix generation decoder against the cached cross K/V."""
    for block, (ck, cv) in zip(params["decoder"], kv):
        attn_out = x + _self_attention(block["attn"], rms_norm(x, block["attn_norm"]),
                                       cfg.num_heads, causal=True, k_mask=None)
        hc = rms_norm(x, block["cross_attn_norm"])  # quirk: block input x
        attn_out = attn_out + _cross_from_cache(block, hc, ck, cv, context_mask,
                                                cfg.num_heads, beams, x.dtype)
        x = attn_out + mlp.apply(block["ff_mlp"], rms_norm(attn_out, block["ff_norm"]))
    return x


def decode_step_with_kv(params, cfg: TransformerConfig, x_new: torch.Tensor, self_kv, kv,
                        context_mask: torch.Tensor, *, beams: int = 1):
    """Single-token decoder step with a growing self-attention KV cache.

    ``x_new`` (B*beams, 1, d_model) is the newest token; ``self_kv`` is None
    (first token) or per block (k, v), each (B*beams, T, H, Dh)
    (``tp.local_heads`` of them under tensor parallelism). The newest
    position attends every cached one, so causality needs no mask.
    Returns (x_out, new self_kv with T+1 entries)."""
    x = x_new
    new_kv = []
    heads = tp.local_heads(cfg.num_heads)
    for li, (block, (ck, cv)) in enumerate(zip(params["decoder"], kv)):
        h = rms_norm(x, block["attn_norm"])
        p = block["attn"]
        q1, k1, v1 = (attn_ops.split_heads(t, heads)
                      for t in torch.chunk(h @ p["wqkv"].to(h.dtype), 3, dim=-1))
        if self_kv is None:
            k_full, v_full = k1, v1
        else:
            pk, pv = self_kv[li]
            k_full = torch.cat([pk, k1], dim=1)
            v_full = torch.cat([pv, v1], dim=1)
        new_kv.append((k_full, v_full))
        attn_out = x + _out_proj(p, attn_ops.attend(q1, k_full, v_full, causal=False), x.dtype,
                                 cfg.num_heads)
        hc = rms_norm(x, block["cross_attn_norm"])  # quirk: block input x
        attn_out = attn_out + _cross_from_cache(block, hc, ck, cv, context_mask,
                                                cfg.num_heads, beams, x.dtype)
        x = attn_out + mlp.apply(block["ff_mlp"], rms_norm(attn_out, block["ff_norm"]))
    return x, tuple(new_kv)
