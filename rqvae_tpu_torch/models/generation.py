"""Constrained beam search over the corpus semantic-ID prefix trie
(counterpart of rqvae_tpu/models/generation.py).

The encoder runs once on the B input rows and every decoder block's cross
K/V is cached at B rows (beams fold into the attention query axis); each
step embeds and decodes only the newest token against a self-attention KV
cache that is reordered by beam parent after every top-k. The validity of
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
from rqvae_tpu_torch.models import retrieval
from rqvae_tpu_torch.models.retrieval import RetrievalConfig
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


def generate_next_sem_ids(params, cfg: RetrievalConfig, index: semids.CorpusIndex,
                          batch: TokenizedSeqBatch, generator: Optional[torch.Generator] = None,
                          *, k: int = 32, n_candidates: int = 200, temperature: float = 1.0,
                          uniforms: Optional[Sequence[torch.Tensor]] = None) -> GenerationOutput:
    """Generate the next item's sem-ID tuple with k constrained beams."""
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
        # ---- step 0: encoder once, cross K/V cached, BOS decoded ----
        with profiling.span("search.encode"):
            bos_batch = batch._replace(sem_ids_fut=None, token_type_ids_fut=None)
            cache = retrieval.encode_for_generation(params, cfg, bos_batch)
        with profiling.span("search.level", level=0):
            logits, self_kv = retrieval.decode_token_cached(params, cfg, cache, None, None, 0,
                                                            beams=1, n_rows=b)
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
            # every beam of a row starts from the same BOS self-attention cache
            self_kv = tree_map(
                lambda c: c[:, None].expand(b, k, *c.shape[1:]).reshape(b * k, *c.shape[1:]),
                self_kv,
            )
        rows = torch.arange(b, device=dev)[:, None]

        # ---- steps 1..D-1: one new token per beam, KV cache reordered ----
        for i in range(1, d):
            with profiling.span("search.level", level=i):
                fut = generated.reshape(b * k, i)
                logits, self_kv = retrieval.decode_token_cached(
                    params, cfg, cache, self_kv, fut[:, -1], i - 1, beams=k, n_rows=b * k)
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
                    # each surviving beam inherits its parent's self-attention cache
                    self_kv = tree_map(
                        lambda c: c.reshape(b, k, *c.shape[1:])[rows, parent].reshape(c.shape),
                        self_kv,
                    )
    return GenerationOutput(sem_ids=generated, log_probas=log_probas)
