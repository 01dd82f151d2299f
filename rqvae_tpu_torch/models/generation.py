"""Constrained beam search over the corpus semantic-ID prefix trie
(counterpart of rqvae_tpu/models/generation.py).

One loop drives either model. The encoder-decoder (``models/retrieval``):
the encoder runs once on the B input rows and every decoder block's cross
K/V is cached at B rows (beams fold into the attention query axis); each
step embeds and decodes only the newest token against a self-attention KV
cache that is reordered by beam parent after every top-k. The decoder-only
model (``models/retrieval_lm``): the histories are prefilled once (their
last token gives the first level's logits) and each step decodes the
newest token against the history's latent cache, shared by a user's beams,
and the beams' own latent cache, reordered by beam parent. The validity of
each beam's next token comes from ``semids.children_mask`` (the
``children_window`` kernel).

Candidates: with ``n_candidates >= K`` every token is a candidate (the
exhaustive branch, no noise). Otherwise the candidate set is a Gumbel-top-n
sample of each row, as a dense mask. Its uniforms come from ``generator``, or
from ``uniforms`` (one tensor per step: (B, K) then (B*k, K)) so a test can
feed this and the JAX package the same noise.

Scores are -10000 * invalid + log p(token) + the beam's cumulative log-prob,
computed in fp32 whatever the weights' dtype. ``torch.topk`` does not promise
an order among equal scores; ``jax.lax.top_k`` keeps the lower index first.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from rqvae_tpu_torch.data.schemas import TokenizedSeqBatch
from rqvae_tpu_torch.models import retrieval, retrieval_lm
from rqvae_tpu_torch.models.retrieval import RetrievalConfig
from rqvae_tpu_torch.models.retrieval_lm import RetrievalLMConfig
from rqvae_tpu_torch.tokenizer import semids
from rqvae_tpu_torch.utils import profiling
from rqvae_tpu_torch.utils.tree import tree_map

INVALID_PENALTY = -10000.0


class GenerationOutput(NamedTuple):
    sem_ids: torch.Tensor     # (B, k, D) int32
    log_probas: torch.Tensor  # (B, k)


def _gumbel_topk_mask(logp: torch.Tensor, n: int, u: torch.Tensor) -> torch.Tensor:
    """Boolean mask of the Gumbel-top-n sample of each row of ``logp``,
    given uniforms ``u`` of the same shape. The threshold is the n-th
    largest perturbed value, found with a top-k of min(n, K-n+1)."""
    k_vocab = logp.shape[-1]
    perturbed = logp + -torch.log(-torch.log(u + 1e-20) + 1e-20)
    if n <= k_vocab - n + 1:
        thresh = torch.topk(perturbed, n, dim=-1).values[..., -1:]
    else:  # n-th largest == (K-n+1)-th smallest
        thresh = -torch.topk(-perturbed, k_vocab - n + 1, dim=-1).values[..., -1:]
    return perturbed >= thresh


class _EncDecSearch:
    """The encoder-decoder's steps: the encoder once with every decoder
    block's cross K/V cached, then one token a step against a
    self-attention KV cache."""

    def __init__(self, params, cfg: RetrievalConfig, batch: TokenizedSeqBatch):
        self.params, self.cfg = params, cfg
        with profiling.span("search.encode"):
            bos_batch = batch._replace(sem_ids_fut=None, token_type_ids_fut=None)
            self.cache = retrieval.encode_for_generation(params, cfg, bos_batch)

    def first(self, b: int) -> torch.Tensor:
        logits, self.self_kv = retrieval.decode_token_cached(self.params, self.cfg, self.cache,
                                                             None, None, 0, beams=1, n_rows=b)
        return logits

    def expand(self, b: int, k: int) -> None:
        # every beam of a row starts from the same BOS self-attention cache
        self.b, self.k = b, k
        self.self_kv = tree_map(
            lambda c: c[:, None].expand(b, k, *c.shape[1:]).reshape(b * k, *c.shape[1:]),
            self.self_kv,
        )

    def next(self, tokens: torch.Tensor, level: int) -> torch.Tensor:
        logits, self.self_kv = retrieval.decode_token_cached(
            self.params, self.cfg, self.cache, self.self_kv, tokens, level, beams=self.k,
            n_rows=self.b * self.k)
        return logits

    def reorder(self, rows: torch.Tensor, parent: torch.Tensor) -> None:
        # each surviving beam inherits its parent's self-attention cache
        b, k = parent.shape
        self.self_kv = tree_map(
            lambda c: c.reshape(b, k, *c.shape[1:])[rows, parent].reshape(c.shape), self.self_kv)


class _LMSearch:
    """The decoder-only model's steps (``models/retrieval_lm``): the
    history prefilled once, its latent cache shared by each user's beams,
    then one token a step against it and the beams' own latent cache."""

    def __init__(self, params, cfg: RetrievalLMConfig, batch: TokenizedSeqBatch):
        self.params, self.cfg, self.own = params, cfg, None
        with profiling.span("search.prefill"):
            self.logits, self.hist = retrieval_lm.prefill(params, cfg, batch)

    def first(self, b: int) -> torch.Tensor:
        return self.logits

    def expand(self, b: int, k: int) -> None:
        pass   # the history cache stays one row a user; the own caches start at the next step

    def next(self, tokens: torch.Tensor, level: int) -> torch.Tensor:
        logits, self.own = retrieval_lm.decode_step(self.params, self.cfg, self.hist, self.own,
                                                    tokens, level)
        return logits

    def reorder(self, rows: torch.Tensor, parent: torch.Tensor) -> None:
        self.own = retrieval_lm.reorder(self.own, rows, parent)


def generate_next_sem_ids(params, cfg, index: semids.CorpusIndex,
                          batch: TokenizedSeqBatch, generator: Optional[torch.Generator] = None,
                          *, k: int = 32, n_candidates: int = 200, temperature: float = 1.0,
                          uniforms: Optional[Sequence[torch.Tensor]] = None) -> GenerationOutput:
    """Generate the next item's sem-ID tuple with k constrained beams, by
    the encoder-decoder (``cfg`` a ``RetrievalConfig``) or the decoder-only
    model (a ``RetrievalLMConfig``)."""
    b = batch.sem_ids.shape[0]
    d = cfg.sem_id_dim
    n_vocab = cfg.num_embeddings
    n_candidates = min(n_candidates, n_vocab)
    exhaustive = n_candidates >= n_vocab
    if not exhaustive and generator is None and uniforms is None:
        raise ValueError("sampled candidates need a generator or injected uniforms")

    def sample_mask(step: int, logp: torch.Tensor) -> torch.Tensor:
        if uniforms is not None:
            u = uniforms[step].to(device=logp.device, dtype=torch.float32)
        else:
            u = torch.rand(logp.shape, generator=generator, device=generator.device)
            u = u.to(logp.device)
        return _gumbel_topk_mask(logp, n_candidates, u)

    with torch.no_grad(), profiling.span("search"):
        model = (_LMSearch if isinstance(cfg, RetrievalLMConfig) else _EncDecSearch)(
            params, cfg, batch)
        with profiling.span("search.level", level=0):
            logits = model.first(b)
            logp = torch.log_softmax(logits.float() / temperature, dim=-1)      # (B, K)
            dev = logp.device
            with profiling.span("search.children_mask"):
                allowed = semids.children_mask(
                    index, torch.zeros((1, 0), dtype=torch.int32, device=dev))   # (1, K)
            if not exhaustive:
                allowed = sample_mask(0, logp) & allowed
            scores = torch.where(allowed, 0.0, INVALID_PENALTY) + logp
            log_probas, top_idx = torch.topk(scores, k, dim=-1)                 # (B, k)
            generated = top_idx.to(torch.int32)[..., None]                      # (B, k, 1)
            model.expand(b, k)
        rows = torch.arange(b, device=dev)[:, None]

        # ---- steps 1..D-1: one new token per beam, caches reordered ----
        for i in range(1, d):
            with profiling.span("search.level", level=i):
                fut = generated.reshape(b * k, i)
                logits = model.next(fut[:, -1], i - 1)
                logp = torch.log_softmax(logits.float() / temperature, dim=-1)  # (B*k, K)
                with profiling.span("search.children_mask"):
                    mask = semids.children_mask(index, fut)                     # (B*k, K)
                if not exhaustive:
                    mask = mask & sample_mask(i, logp)
                scores = (torch.where(mask, 0.0, INVALID_PENALTY) + logp
                          + log_probas.reshape(b * k, 1)).reshape(b, k * n_vocab)
                log_probas, top_idx = torch.topk(scores, k, dim=-1)            # (B, k)
                parent = torch.clamp(top_idx // n_vocab, 0, k - 1)
                winner = (top_idx % n_vocab).to(torch.int32)
                generated = torch.cat([generated[rows, parent], winner[..., None]], dim=-1)
                if i < d - 1:
                    model.reorder(rows, parent)
    return GenerationOutput(sem_ids=generated, log_probas=log_probas)
