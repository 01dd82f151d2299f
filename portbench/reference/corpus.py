"""The plain reference of the corpus side of serving: the RQ-VAE's encoder
and residual quantization that give each item its semantic-ID tuple, the
dedup column that makes tuples unique, the prefix sets that say which next
token a beam may take, and the weights of an RQ-VAE made from a seed.

Tokenization: ``z = encoder(x)`` (bias-free linear layers, SiLU between
them), then per level the nearest codeword by squared L2 distance (the
lowest index on a tie), ``z -= codeword``. The dedup column of an item is
the number of earlier items (in corpus order) with the same tuple.

A tokenizer that sums the distance's terms in another order can pick
another codeword where two are nearly equally near. ``tokenize`` takes the
program's codes to judge them: where the program's code at a level is not
the reference's but lies within ``TIE`` of the nearest distance, it is as
right as the reference's and the reference continues from it; any other
difference is counted as a mismatch.
"""
from __future__ import annotations

from typing import Optional

import torch

TIE = 1e-5   # relative distance within which two codewords are equally near


def encoder_shapes(rq: dict):
    dims = [int(rq["vae_input_dim"]), *map(int, rq["vae_hidden_dims"]), int(rq["vae_embed_dim"])]
    return list(zip(dims[:-1], dims[1:]))


def encode(weights, x: torch.Tensor) -> torch.Tensor:
    for i, w in enumerate(weights):
        x = x @ w
        if i != len(weights) - 1:
            x = torch.nn.functional.silu(x)
    return x


def init_rqvae(gen: torch.Generator, rq: dict, items: torch.Tensor) -> dict:
    """RQ-VAE weights from ``gen``: encoder and decoder linear layers
    U(-1/sqrt(in), 1/sqrt(in)), then each level's codebook set to the
    residuals (after the levels before it) of ``codebook_size`` items drawn
    from ``gen``, other items for each level (the seeding a k-means priming
    starts from), so the codes spread over the codebook as a trained
    tokenizer's do. The layout is the port's."""
    dev = items.device
    shapes = encoder_shapes(rq)
    dec_shapes = [(o, i) for i, o in reversed(shapes)]
    total = sum(i * o for i, o in shapes + dec_shapes)
    uni = torch.rand((total,), generator=gen, device=gen.device).to(dev)
    mats, at = [], 0
    for i, o in shapes + dec_shapes:
        b = 1.0 / i ** 0.5
        mats.append((uni[at:at + i * o].reshape(i, o) * (2 * b) - b).contiguous())
        at += i * o
    enc = mats[:len(shapes)]
    k, levels = int(rq["vae_codebook_size"]), int(rq.get("vae_n_layers", 3))
    pick = torch.randperm(items.shape[0], generator=gen, device=gen.device)[:k * levels].to(dev)
    layers = []
    with torch.no_grad():
        for lvl in range(levels):
            res = encode(enc, items[pick[lvl * k:(lvl + 1) * k]])
            for layer in layers:
                cb = layer["codebook"]
                d = (res * res).sum(-1, keepdim=True) + (cb * cb).sum(-1)[None] - 2.0 * res @ cb.T
                res = res - cb[torch.argmin(d, dim=-1)]
            layers.append({"codebook": res.contiguous()})
    return {"encoder": enc, "decoder": mats[len(shapes):], "layers": layers}


def tokenize(params: dict, items: torch.Tensor, program: Optional[torch.Tensor] = None,
             chunk: int = 4096):
    """(codes (n, L) int64, mismatches): the reference's codes of every item,
    adopting the program's ``program`` (n, >= L) at near-ties (see the
    module docstring); ``mismatches`` counts the items whose program codes
    differ beyond a near-tie (0 without ``program``)."""
    cbs = [layer["codebook"].float() for layer in params["layers"]]
    out, bad = [], 0
    with torch.no_grad():
        for lo in range(0, items.shape[0], chunk):
            res = encode(params["encoder"], items[lo:lo + chunk].float())
            codes = []
            wrong = torch.zeros(res.shape[0], dtype=torch.bool, device=res.device)
            for lvl, cb in enumerate(cbs):
                d = (res * res).sum(-1, keepdim=True) + (cb * cb).sum(-1)[None] - 2.0 * res @ cb.T
                best = torch.argmin(d, dim=-1)
                if program is not None:
                    theirs = program[lo:lo + chunk, lvl].to(best.device).long()
                    dmin = d.gather(1, best[:, None])[:, 0]
                    dt = d.gather(1, theirs.clamp(0, cb.shape[0] - 1)[:, None])[:, 0]
                    scale = (res * res).sum(-1) + (cb * cb).sum(-1).max()
                    near = (theirs >= 0) & (theirs < cb.shape[0]) & (dt - dmin <= TIE * scale)
                    wrong |= (theirs != best) & ~near
                    best = torch.where(near, theirs, best)
                codes.append(best)
                res = res - cb[best]
            out.append(torch.stack(codes, dim=1))
            bad += int(wrong.sum())
    return torch.cat(out), bad


def dedup(codes: torch.Tensor) -> torch.Tensor:
    """Occurrence rank of each row's tuple among the rows before it."""
    n = codes.shape[0]
    key = torch.zeros(n, dtype=torch.int64, device=codes.device)
    for c in range(codes.shape[1]):
        key = key * (int(codes[:, c].max()) + 1) + codes[:, c]
    order = torch.argsort(key * n + torch.arange(n, device=codes.device))
    sk = key[order]
    first = torch.ones(n, dtype=torch.bool, device=codes.device)
    first[1:] = sk[1:] != sk[:-1]
    pos = torch.arange(n, device=codes.device)
    start = torch.cummax(torch.where(first, pos, 0), dim=0).values
    out = torch.empty(n, dtype=torch.int64, device=codes.device)
    out[order] = pos - start
    return out


class Prefixes:
    """The sets of the corpus's tuple prefixes, one a length, as sorted
    integer keys in one radix (above every code and dedup value)."""

    def __init__(self, tuples: torch.Tensor, codebook: int):
        self.codebook = codebook
        self.radix = max(codebook, int(tuples.max()) + 1)
        self.sets = []
        key = torch.zeros(tuples.shape[0], dtype=torch.int64, device=tuples.device)
        for c in range(tuples.shape[1]):
            key = key * self.radix + tuples[:, c].long()
            self.sets.append(torch.unique(key))

    def keys(self, prefix: torch.Tensor) -> torch.Tensor:
        key = torch.zeros(prefix.shape[0], dtype=torch.int64, device=prefix.device)
        for c in range(prefix.shape[1]):
            key = key * self.radix + prefix[:, c].long()
        return key

    def _member(self, length: int, key: torch.Tensor) -> torch.Tensor:
        table = self.sets[length - 1]
        pos = torch.searchsorted(table, key).clamp(max=table.shape[0] - 1)
        return table[pos] == key

    def allowed(self, prefix: torch.Tensor) -> torch.Tensor:
        """(R, K) bool: token t may follow ``prefix`` (R, L) iff the corpus
        holds the prefix extended by t."""
        tok = torch.arange(self.codebook, device=prefix.device)
        cand = self.keys(prefix)[:, None] * self.radix + tok
        return self._member(prefix.shape[1] + 1, cand)

    def contains(self, tuples: torch.Tensor) -> torch.Tensor:
        return self._member(tuples.shape[1], self.keys(tuples))
