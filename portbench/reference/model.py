"""The plain reference of the generative-retrieval decoder: an
encoder-decoder transformer over semantic-ID tokens, in plain PyTorch and
float32, written from the model's description and independent of the port.

The model (TIGER, arXiv:2305.05065, as the reference repository
AdamLTy/RQ-VAE-Recommender builds it):

* history stream: a user token (hash bucket ``|id| % 2000``) then, per item,
  its semantic-ID tokens, each the sum of a level-offset embedding row
  (``level * K + id``; masked positions read a zero row) and a learned
  absolute position; target stream: a learned BOS then the target's tokens
  plus a token-type embedding;
* RMSNorm (fp32 statistics, eps 1e-6) and an input projection on each
  stream, input dropout 0.5 in training;
* pre-RMSNorm blocks without biases: ``a = x + self_attn(drop(norm(x)))``;
  decoder blocks add ``cross_attn(drop(norm_c(x)), context)`` whose query
  reads the block input ``x``; then ``a + drop(mlp(norm_f(a)))``, the MLP
  ``silu(a W0)`` with dropout, then ``W1``;
* the encoder's attention under the history's key mask, the decoder's self
  attention causal, the cross attention under the history's key mask;
* logits ``out W_out`` at the target positions, cross entropy summed over a
  tuple's positions and meaned over the batch.

Dropout draws ``bernoulli(1 - p)`` masks of each activation's shape from one
generator, in the order the forward reaches them; given the generator state
the program started its step from, the reference draws the same masks.
Attention is dense: every score computed, masked to -1e30, softmax in fp32.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

NEG = -1e30
USER_BUCKETS = 2000
INPUT_DROPOUT = 0.5


class DecoderShape(NamedTuple):
    """The sizes the reference needs, from a configuration file's
    ``decoder`` block and the history length."""

    embedding_dim: int
    attn_dim: int
    heads: int
    layers: int          # encoder + decoder, half each
    mlp_dim: int
    codebook: int        # K
    sem_dim: int         # levels + the dedup column
    max_pos: int
    dropout: float


def decoder_shape(dec: dict, max_seq_len: int) -> DecoderShape:
    sem = int(dec["vae_n_layers"]) + 1 if "vae_n_layers" in dec else 4
    return DecoderShape(
        embedding_dim=int(dec["decoder_embed_dim"]), attn_dim=int(dec["attn_embed_dim"]),
        heads=int(dec["attn_heads"]), layers=int(dec["attn_layers"]),
        mlp_dim=int(dec.get("mlp_hidden_dim", 1024)), codebook=int(dec["vae_codebook_size"]),
        sem_dim=sem, max_pos=max_seq_len * sem, dropout=float(dec["dropout_p"]))


# ---------------------------------------------------------------------------
# Weights made from a seed, in a few large draws
# ---------------------------------------------------------------------------

def _linear_shapes(s: DecoderShape):
    """(path, (in, out)) of every weight matrix, in one fixed order."""
    a, e, f = s.attn_dim, s.embedding_dim, s.mlp_dim
    out = [(("in_proj",), (e, a)), (("in_proj_context",), (e, a)), (("out_proj",), (a, s.codebook))]
    for side, n in (("encoder", s.layers // 2), ("decoder", s.layers // 2)):
        for i in range(n):
            base = ("transformer", side, i)
            out += [(base + ("attn", "wqkv"), (a, 3 * a)), (base + ("attn", "proj"), (a, a)),
                    (base + ("ff_mlp", 0), (a, f)), (base + ("ff_mlp", 1), (f, a))]
            if side == "decoder":
                out += [(base + ("cross_attn", "wq"), (a, a)),
                        (base + ("cross_attn", "wkv"), (a, 2 * a)),
                        (base + ("cross_attn", "proj"), (a, a))]
    return out


def _put(tree, path, value):
    node = tree
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = value


def init_decoder(gen: torch.Generator, s: DecoderShape, device) -> dict:
    """The decoder's weights in the layout the port takes: linear layers
    U(-1/sqrt(in), 1/sqrt(in)) stored (in, out), embedding tables N(0, 1)
    (the sem-ID table's rows from K * D on zero), BOS U(0, 1), norms one.
    Two draws on ``gen``'s device: one uniform buffer, one normal one."""
    e, a = s.embedding_dim, s.attn_dim
    sem_rows = -(-(s.codebook * s.sem_dim + 1) // 16) * 16
    normal_shapes = [("sem_emb", (sem_rows, e)), ("user_emb", (USER_BUCKETS, e)),
                     ("wpe", (s.max_pos, e)), ("tte", (s.sem_dim, e))]
    lin = _linear_shapes(s)
    n_uni = e + sum(i * o for _, (i, o) in lin)
    n_norm = sum(r * c for _, (r, c) in normal_shapes)
    uni = torch.rand((n_uni,), generator=gen, device=gen.device).to(device)
    nrm = torch.randn((n_norm,), generator=gen, device=gen.device).to(device)
    ones = lambda n: torch.ones((n,), device=device)  # noqa: E731
    block = lambda cross: ({"attn": {}, "attn_norm": ones(a), "ff_norm": ones(a), "ff_mlp": [None, None],  # noqa: E731
                            **({"cross_attn": {}, "cross_attn_norm": ones(a)} if cross else {})})
    params = {"bos": uni[:e].clone(), "norm": ones(e), "norm_cxt": ones(e),
              "transformer": {"encoder": [block(False) for _ in range(s.layers // 2)],
                              "decoder": [block(True) for _ in range(s.layers // 2)]}}
    at = e
    for path, (i, o) in lin:
        bound = 1.0 / math.sqrt(i)
        _put(params, path, (uni[at:at + i * o].reshape(i, o) * (2 * bound) - bound).contiguous())
        at += i * o
    at = 0
    for name, (r, c) in normal_shapes:
        params[name] = nrm[at:at + r * c].reshape(r, c).clone()
        at += r * c
    params["sem_emb"][s.codebook * s.sem_dim:] = 0.0
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return (xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + 1e-6)).to(x.dtype) * w


def dropout(x: torch.Tensor, p: float, gen: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout; identity without a generator (eval) or at p = 0."""
    if gen is None or p <= 0.0:
        return x
    keep = torch.empty(x.shape, dtype=torch.bool, device=x.device).bernoulli_(1.0 - p, generator=gen)
    return torch.where(keep, x / (1.0 - p), 0.0)


def attention(q, k, v, mask) -> torch.Tensor:
    """Dense masked attention over (B, N, H, Dh); ``mask`` broadcasts to
    (B, H, Nq, Nk), True = attend; a row with no key gives 0."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(q.shape[-1])
    s = torch.where(mask, s, NEG)
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.any(mask, dim=-1, keepdim=True), p, 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def _heads(x, h):
    b, n, d = x.shape
    return x.reshape(b, n, h, d // h)


def _merge(x):
    b, n, h, d = x.shape
    return x.reshape(b, n, h * d)


def _self_attn(p, x, h, mask):
    q, k, v = torch.chunk(x @ p["wqkv"], 3, dim=-1)
    return _merge(attention(_heads(q, h), _heads(k, h), _heads(v, h), mask)) @ p["proj"]


def _cross_attn(p, x, context, h, mask):
    q = x @ p["wq"]
    k, v = torch.chunk(context @ p["wkv"], 2, dim=-1)
    return _merge(attention(_heads(q, h), _heads(k, h), _heads(v, h), mask)) @ p["proj"]


def _block(p, s: DecoderShape, x, self_mask, gen, context=None, cross_mask=None):
    drop = lambda t: dropout(t, s.dropout, gen)  # noqa: E731
    a = x + _self_attn(p["attn"], drop(rms_norm(x, p["attn_norm"])), s.heads, self_mask)
    if context is not None:
        a = a + _cross_attn(p["cross_attn"], drop(rms_norm(x, p["cross_attn_norm"])), context,
                            s.heads, cross_mask)
    w0, w1 = p["ff_mlp"]
    hidden = drop(torch.nn.functional.silu(rms_norm(a, p["ff_norm"]) @ w0))
    return a + drop(hidden @ w1)


def _sem_embed(table, sem_ids, levels, k, mask=None):
    pad = table.shape[0] - 1
    idx = levels.long() * k + sem_ids.long()
    if mask is not None:
        idx = torch.where(mask, idx, pad)
    return table[idx.clamp(0, pad)]


def embed_history(params, s: DecoderShape, sem_ids, seq_mask, user_ids):
    """(B, 1 + N, E) history embedding and its (B, 1 + N) key mask."""
    b, n = sem_ids.shape
    levels = torch.arange(s.sem_dim, device=sem_ids.device).repeat(n // s.sem_dim)[None]
    x = _sem_embed(params["sem_emb"], sem_ids, levels.expand(b, n), s.codebook, seq_mask)
    x = x + params["wpe"][torch.arange(n, device=x.device).clamp(max=params["wpe"].shape[0] - 1)]
    user = params["user_emb"][user_ids.long().abs() % params["user_emb"].shape[0]]
    ones = torch.ones((b, 1), dtype=torch.bool, device=x.device)
    return torch.cat([user[:, None], x], dim=1), torch.cat([ones, seq_mask], dim=1)


def embed_targets(params, s: DecoderShape, fut):
    """(R, 1 + T, E): BOS then the first T target tokens (``fut`` (R, T))."""
    r, t = fut.shape
    bos = params["bos"].expand(r, 1, s.embedding_dim)
    if t == 0:
        return bos
    levels = torch.arange(t, device=fut.device)[None].expand(r, t)
    x = _sem_embed(params["sem_emb"], fut, levels, s.codebook) + params["tte"][levels]
    return torch.cat([bos, x], dim=1)


def encode(params, s: DecoderShape, ctx_emb, ctx_mask, gen=None):
    x = dropout(rms_norm(ctx_emb, params["norm"]), INPUT_DROPOUT, gen) @ params["in_proj_context"]
    mask = ctx_mask[:, None, None, :]
    for p in params["transformer"]["encoder"]:
        x = _block(p, s, x, mask, gen)
    return x


def decode(params, s: DecoderShape, fut_in, context, ctx_mask, gen=None):
    n = fut_in.shape[1]
    causal = torch.tril(torch.ones((n, n), dtype=torch.bool, device=fut_in.device))[None, None]
    cross = ctx_mask[:, None, None, :]
    x = fut_in
    for p in params["transformer"]["decoder"]:
        x = _block(p, s, x, causal, gen, context, cross)
    return x @ params["out_proj"]


def train_loss(params, s: DecoderShape, sem_ids, seq_mask, user_ids, sem_fut, gen):
    """(loss, loss by position) of one batch in training mode: dropout from
    ``gen`` in the order the forward reaches it (input dropout of the
    history, then of the targets, then block by block)."""
    ctx_emb, ctx_mask = embed_history(params, s, sem_ids, seq_mask, user_ids)
    fut_emb = embed_targets(params, s, sem_fut)
    h_ctx = dropout(rms_norm(ctx_emb, params["norm"]), INPUT_DROPOUT, gen)
    h_fut = dropout(rms_norm(fut_emb, params["norm_cxt"]), INPUT_DROPOUT, gen)
    x = h_ctx @ params["in_proj_context"]
    mask = ctx_mask[:, None, None, :]
    for p in params["transformer"]["encoder"]:
        x = _block(p, s, x, mask, gen)
    logits = decode(params, s, h_fut @ params["in_proj"], x, ctx_mask, gen)[:, :-1]
    valid = (sem_fut >= 0) & (sem_fut < s.codebook)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, sem_fut.long().clamp(0, s.codebook - 1)[..., None])[..., 0]
    nll = torch.where(valid, nll, 0.0)
    return torch.mean(torch.sum(nll, dim=1)), torch.mean(nll, dim=0)


def target_logp(params, s: DecoderShape, context, ctx_mask, fut):
    """Log-probabilities (R, T + 1, K) at every target position given the
    history's encoder output (one row of ``context`` a row of ``fut``)."""
    fut_in = rms_norm(embed_targets(params, s, fut), params["norm_cxt"]) @ params["in_proj"]
    return torch.log_softmax(decode(params, s, fut_in, context, ctx_mask).float(), dim=-1)


def history_context(params, s: DecoderShape, sem_ids, seq_mask, user_ids):
    """Eval-mode encoder output and key mask of a batch of histories."""
    ctx_emb, ctx_mask = embed_history(params, s, sem_ids, seq_mask, user_ids)
    return encode(params, s, ctx_emb, ctx_mask), ctx_mask
