"""The plain reference of the decoder-only retriever on DeepSeek-V2's block,
in plain PyTorch and float32, written from DeepSeek-V2's modelling code
(``modeling_deepseek.py`` of deepseek-ai/DeepSeek-V2-Lite: ``DeepseekV2Attention``
without query compression, ``DeepseekV2YarnRotaryEmbedding``,
``apply_rotary_pos_emb``, ``MoEGate``, ``DeepseekV2MoE``, ``DeepseekV2MLP``,
``DeepseekV2RMSNorm``) and independent of the port. No cache: every
sequence runs whole, unpadded (sequences of one length at a time).

A sequence is ``[user token, semantic-ID tokens]``: the user's hash bucket
row ``|id| % 2000`` of one table, then each token's row ``level * K + id``
of the level-offset table, at positions 0, 1, ...; the logits at a
position give the next token's. Each layer::

    h = x + o_proj(attn(rms(x)));  x = h + ffn(rms(h))

then a final RMSNorm and the head. Attention (per token, 16 heads):
``q = x W_q`` split into ``q_nope`` (128) and ``q_pe`` (64); ``[c, k_pe] =
x W_kva`` (512 + 64), ``c = rms(c)``; ``[k_nope, v] = c W_kvb`` (128 + 128 a
head); RoPE with YaRN on ``q_pe`` and the one ``k_pe`` of the token (pairs
de-interleaved, then rotate-half); causal softmax of ``q . [k_nope, k_pe]``
times ``192^-0.5 (0.1 * 0.707 * ln 40 + 1)^2``. The FFN is SwiGLU
``W_d (silu(x W_gate) * x W_up)``: width 10,944 in the first layer; in the
others the router ``softmax(x W_g)`` over 64 experts picks 6 (greedy, the
weights not renormalised, times 1), ``sum_e w_e E_e(x)`` over them (a loop
over the experts with index masks) plus the 2 shared experts as one SwiGLU
of 2,816.

Departures from DeepSeek-V2-Lite, each the configuration's: the vocabulary
(102,400 text tokens replaced by 4 x 256 semantic-ID rows, 2,000 user
buckets and a 256-way head shared by the levels); the depth (27 layers cut
to 8: the dense layer and 7 expert layers); no auxiliary loss (serving
only); random weights from a seed.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Sequence

import torch

from portbench.reference.corpus import Prefixes
from portbench.reference.search import PENALTY

USER_BUCKETS = 2000
INIT_STD = 0.02       # DeepSeek-V2's initializer_range
INIT_FAN_IN = 2048    # DeepSeek-V2-Lite's hidden size


class LMShape(NamedTuple):
    hidden: int
    heads: int
    layers: int
    nope: int
    rope: int
    v: int
    rank: int
    dense_width: int
    first_dense: int
    experts: int
    expert_width: int
    shared: int
    top_k: int
    scaling: float
    eps: float
    theta: float
    factor: float
    original_max: int
    beta_fast: float
    beta_slow: float
    mscale: float
    mscale_all_dim: float
    codebook: int
    sem_dim: int


def lm_shape(cfg: dict) -> LMShape:
    """From a configuration file: DeepSeek-V2's keys at its top level; the
    hidden size, heads, depth and codebook from its ``decoder`` block."""
    dec, rs = cfg["decoder"], cfg["rope_scaling"]
    return LMShape(
        hidden=int(dec["attn_embed_dim"]), heads=int(dec["attn_heads"]),
        layers=int(dec["attn_layers"]), nope=int(cfg["qk_nope_head_dim"]),
        rope=int(cfg["qk_rope_head_dim"]), v=int(cfg["v_head_dim"]), rank=int(cfg["kv_lora_rank"]),
        dense_width=int(cfg["intermediate_size"]), first_dense=int(cfg["first_k_dense_replace"]),
        experts=int(cfg["n_routed_experts"]), expert_width=int(cfg["moe_intermediate_size"]),
        shared=int(cfg["n_shared_experts"]), top_k=int(cfg["num_experts_per_tok"]),
        scaling=float(cfg["routed_scaling_factor"]), eps=float(cfg["rms_norm_eps"]),
        theta=float(cfg["rope_theta"]), factor=float(rs["factor"]),
        original_max=int(rs["original_max_position_embeddings"]), beta_fast=float(rs["beta_fast"]),
        beta_slow=float(rs["beta_slow"]), mscale=float(rs["mscale"]),
        mscale_all_dim=float(rs["mscale_all_dim"]), codebook=int(dec["vae_codebook_size"]),
        sem_dim=int(dec.get("vae_n_layers", 3)) + 1)


# ---------------------------------------------------------------------------
# Weights from a seed
# ---------------------------------------------------------------------------

def _shapes(s: LMShape):
    """(path, shape, kind) of every weight, in one fixed order; kind
    ``linear`` (in, out) is N(0, (0.02^2) 2048 / in): DeepSeek-V2's
    ``initializer_range`` 0.02 at its hidden size 2,048, scaled by the
    fan-in elsewhere (stacked experts by their own), so a cut width keeps
    the activations' scale; ``router`` U(-1/sqrt(in), 1/sqrt(in)) (the
    gate's ``kaiming_uniform_``); ``normal`` N(0, 0.02^2) (embedding
    tables; the layers, not the input embedding, carry the residual
    stream, as in a trained model); ``ones`` a norm's weight."""
    h, heads = s.hidden, s.heads
    rows = -(-(s.codebook * s.sem_dim + 1) // 16) * 16
    out = [(("sem_emb",), (rows, h), "normal"), (("user_emb",), (USER_BUCKETS, h), "normal"),
           (("final_norm",), (h,), "ones"), (("head",), (h, s.codebook), "linear")]
    for i in range(s.layers):
        base = ("layers", i)
        out += [(base + ("attn_norm",), (h,), "ones"),
                (base + ("wq",), (h, heads * (s.nope + s.rope)), "linear"),
                (base + ("wkv_a",), (h, s.rank + s.rope), "linear"),
                (base + ("kv_norm",), (s.rank,), "ones"),
                (base + ("wkv_b",), (s.rank, heads * (s.nope + s.v)), "linear"),
                (base + ("wo",), (heads * s.v, h), "linear"),
                (base + ("ffn_norm",), (h,), "ones")]
        if i < s.first_dense:
            out += [(base + ("mlp", "gate_up"), (h, 2 * s.dense_width), "linear"),
                    (base + ("mlp", "down"), (s.dense_width, h), "linear")]
        else:
            f, fs = s.expert_width, s.shared * s.expert_width
            out += [(base + ("moe", "router"), (h, s.experts), "router"),
                    (base + ("moe", "experts_gate_up"), (s.experts, h, 2 * f), "linear"),
                    (base + ("moe", "experts_down"), (s.experts, f, h), "linear"),
                    (base + ("moe", "shared_gate_up"), (h, 2 * fs), "linear"),
                    (base + ("moe", "shared_down"), (fs, h), "linear")]
    return out


def init_weights(gen: torch.Generator, s: LMShape, device, dtype=torch.bfloat16) -> dict:
    """The model's weights in ``dtype`` (the configuration's precision), in
    the layout the port takes (nested dicts, ``layers`` a list; the
    semantic-ID table's rows from K * D on zero), drawn on ``gen``'s
    device tensor by tensor."""
    params = {"layers": [{} for _ in range(s.layers)]}
    for path, shape, kind in _shapes(s):
        if kind == "ones":
            t = torch.ones(shape, device=device)
        elif kind == "normal":
            t = torch.randn(shape, generator=gen, device=gen.device).to(device) * INIT_STD
        elif kind == "router":
            bound = 1.0 / math.sqrt(shape[-2])
            t = (torch.rand(shape, generator=gen, device=gen.device).to(device) * 2 - 1) * bound
        else:
            std = INIT_STD * math.sqrt(INIT_FAN_IN / shape[-2])
            t = torch.randn(shape, generator=gen, device=gen.device).to(device) * std
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {}) if isinstance(node, dict) else node[key]
        node[path[-1]] = t.to(dtype)
    params["sem_emb"][s.codebook * s.sem_dim:] = 0
    return params


def as_float(tree):
    """The same weights as float32 tensors (the reference computes in
    float32 on the configuration's weights)."""
    if isinstance(tree, dict):
        return {k: as_float(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [as_float(v) for v in tree]
    return tree.float()


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _yarn_mscale(factor: float, m: float) -> float:
    return 0.1 * m * math.log(factor) + 1.0 if factor > 1 else 1.0


def yarn_inv_freq(s: LMShape, device=None) -> torch.Tensor:
    """DeepSeek-V2's YaRN inverse frequencies (``rope`` / 2,)."""
    dim = s.rope

    def corr(rot):   # yarn_find_correction_dim
        return dim * math.log(s.original_max / (rot * 2 * math.pi)) / (2 * math.log(s.theta))

    low = max(math.floor(corr(s.beta_fast)), 0)
    high = min(math.ceil(corr(s.beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    i = torch.arange(0, dim, 2, dtype=torch.float32, device=device)
    extra = 1.0 / s.theta ** (i / dim)
    inter = 1.0 / (s.factor * s.theta ** (i / dim))
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low) / (high - low)).clamp(0, 1)
    mask = 1.0 - ramp
    return inter * (1 - mask) + extra * mask


def rotate(x: torch.Tensor, pos: torch.Tensor, s: LMShape) -> torch.Tensor:
    """RoPE of ``x`` (R, n, rope) or (R, n, heads, rope) at positions
    ``pos`` (n,) (DeepSeek's layout: pairs de-interleaved, then
    rotate-half)."""
    freqs = pos.float()[:, None] * yarn_inv_freq(s, x.device)[None]
    emb = torch.cat([freqs, freqs], dim=-1)
    scale = _yarn_mscale(s.factor, s.mscale) / _yarn_mscale(s.factor, s.mscale_all_dim)
    cos, sin = emb.cos() * scale, emb.sin() * scale
    if x.dim() == 4:
        cos, sin = cos[:, None], sin[:, None]
    d = x.shape[-1]
    x = torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)
    half = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + half * sin


def _swiglu(x, gate_up, down):
    f = down.shape[0]
    return (torch.nn.functional.silu(x @ gate_up[:, :f]) * (x @ gate_up[:, f:])) @ down


def _moe(p, s: LMShape, x, routes=None):
    """x (T, hidden): routed experts (a loop over the experts) plus shared;
    the tokens' experts (T, top_k) appended to ``routes`` if given."""
    scores = torch.softmax(x @ p["router"], dim=-1)
    w, idx = torch.topk(scores, s.top_k, dim=-1)
    if routes is not None:
        routes.append(idx)
    w = w * s.scaling
    y = torch.zeros_like(x)
    for e in range(s.experts):
        hit = idx == e
        rows = hit.any(dim=1)
        if bool(rows.any()):
            we = (w * hit).sum(dim=1)[rows]
            y[rows] += we[:, None] * _swiglu(x[rows], p["experts_gate_up"][e], p["experts_down"][e])
    return y + _swiglu(x, p["shared_gate_up"], p["shared_down"])


def _attention(p, s: LMShape, x, pos):
    """x (R, n, hidden) at positions ``pos`` (n,), causal."""
    r, n, _ = x.shape
    q = (x @ p["wq"]).reshape(r, n, s.heads, s.nope + s.rope)
    q_nope, q_pe = q[..., :s.nope], q[..., s.nope:]
    ckv = x @ p["wkv_a"]
    c, k_pe = rms(ckv[..., :s.rank], p["kv_norm"], s.eps), ckv[..., s.rank:]
    kv = (c @ p["wkv_b"]).reshape(r, n, s.heads, s.nope + s.v)
    k_nope, v = kv[..., :s.nope], kv[..., s.nope:]
    q_pe = rotate(q_pe, pos, s)
    k_pe = rotate(k_pe, pos, s)
    qf = torch.cat([q_nope, q_pe], dim=-1)
    kf = torch.cat([k_nope, k_pe[:, :, None].expand(r, n, s.heads, s.rope)], dim=-1)
    scale = (s.nope + s.rope) ** -0.5 * _yarn_mscale(s.factor, s.mscale_all_dim) ** 2
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    causal = torch.tril(torch.ones((n, n), dtype=torch.bool, device=x.device))
    a = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(r, n, s.heads * s.v)
    return o @ p["wo"]


def forward(params, s: LMShape, users: torch.Tensor, tokens: torch.Tensor,
            levels: torch.Tensor, routes=None) -> torch.Tensor:
    """Logits (R, n, K) of R sequences of one length n: ``users`` (R,) then
    ``tokens`` / ``levels`` (R, n - 1); each expert layer's (R n, top_k)
    experts appended to ``routes`` if given."""
    table = params["sem_emb"]
    x = torch.cat([params["user_emb"][users.long().abs() % USER_BUCKETS][:, None],
                   table[levels.long() * s.codebook + tokens.long()]], dim=1)
    r, n, h = x.shape
    pos = torch.arange(n, device=x.device)
    for i, lp in enumerate(params["layers"]):
        x = x + _attention(lp, s, rms(x, lp["attn_norm"], s.eps), pos)
        hn = rms(x, lp["ffn_norm"], s.eps).reshape(r * n, h)
        ffn = _swiglu(hn, lp["mlp"]["gate_up"], lp["mlp"]["down"]) if i < s.first_dense else _moe(
            lp["moe"], s, hn, routes)
        x = x + ffn.reshape(r, n, h)
    return rms(x, params["final_norm"], s.eps) @ params["head"]


def sequence_logits(params, s: LMShape, users: Sequence[int], seqs: Sequence[List[int]],
                    levels: Sequence[List[int]], chunk: int = 256) -> List[torch.Tensor]:
    """Each sequence's logits (n, K), run in groups of equal length (no
    padding), at most ``chunk`` sequences a forward."""
    dev = params["head"].device
    out = [None] * len(seqs)
    groups = {}
    for i, t in enumerate(seqs):
        groups.setdefault(len(t), []).append(i)
    for idx in groups.values():
        for lo in range(0, len(idx), chunk):
            part = idx[lo:lo + chunk]
            logits = forward(params, s, torch.tensor([users[i] for i in part], device=dev),
                             torch.tensor([seqs[i] for i in part], device=dev).reshape(len(part), -1),
                             torch.tensor([levels[i] for i in part], device=dev).reshape(len(part), -1))
            for j, i in enumerate(part):
                out[i] = logits[j]
    return out


def history_tokens(tuples: torch.Tensor, items: Sequence[int]):
    """(tokens, levels) of a history's valid items (their tuples, level by
    level)."""
    d = tuples.shape[1]
    toks = tuples[torch.as_tensor(list(items), dtype=torch.long, device=tuples.device)].reshape(-1)
    return toks.tolist(), list(range(d)) * len(items)


def _prefixed(hist, prefix):
    toks, lv = hist
    return toks + list(prefix), lv + list(range(len(prefix)))


def beam_search(params, s: LMShape, users, hists, prefixes: Prefixes, k: int):
    """(tuples (B, k, D), scores (B, k)) of each user's history
    (``history_tokens``), best first; every level a whole forward of each
    beam's prefix."""
    b, kk = len(users), s.codebook
    dev = params["head"].device
    seqs = [_prefixed(h, []) for h in hists]
    logp = torch.stack([lg[-1] for lg in sequence_logits(params, s, users, *zip(*seqs))])
    logp = torch.log_softmax(logp, dim=-1)
    empty = torch.zeros((b, 0), dtype=torch.long, device=dev)
    best, idx = torch.topk(torch.where(prefixes.allowed(empty), 0.0, PENALTY) + logp, k, dim=-1)
    tuples = idx[..., None]
    rows = torch.arange(b, device=dev)[:, None]
    for i in range(1, s.sem_dim):
        flat = tuples.reshape(b * k, i)
        beams = flat.tolist()
        seqs = [_prefixed(hists[j // k], beams[j]) for j in range(b * k)]
        rep = [users[j // k] for j in range(b * k)]
        logp = torch.log_softmax(torch.stack(
            [lg[-1] for lg in sequence_logits(params, s, rep, *zip(*seqs))]), dim=-1)
        scores = (torch.where(prefixes.allowed(flat), 0.0, PENALTY) + logp
                  + best.reshape(b * k, 1)).reshape(b, k * kk)
        best, top = torch.topk(scores, k, dim=-1)
        tuples = torch.cat([tuples[rows, top // kk], (top % kk)[..., None]], dim=-1)
    return tuples, best


def rescore(params, s: LMShape, users, hists, prefixes: Prefixes, tuples: torch.Tensor):
    """(scores (B, k), logits (B, k, D, K)) of given tuples (B, k, D): the
    logits at each level from one forward of the history and the tuple's
    first D - 1 tokens, the score the search gives the tuple."""
    b, k, d = tuples.shape
    flat = tuples.reshape(b * k, d).long()
    beams = flat.tolist()
    seqs = [_prefixed(hists[j // k], beams[j][:d - 1]) for j in range(b * k)]
    rep = [users[j // k] for j in range(b * k)]
    logits = torch.stack([lg[-d:] for lg in sequence_logits(params, s, rep, *zip(*seqs))])
    logp = torch.log_softmax(logits, dim=-1)                        # (B k, D, K)
    total = torch.zeros(b * k, device=tuples.device)
    for i in range(d):
        tok = flat[:, i:i + 1].clamp(0, s.codebook - 1)
        ok = prefixes.allowed(flat[:, :i]).gather(1, tok)[:, 0]
        total = total + torch.where(ok, 0.0, PENALTY) + logp[:, i].gather(1, tok)[:, 0]
    return total.reshape(b, k), logits.reshape(b, k, d, -1)
