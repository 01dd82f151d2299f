"""Stage-2 training steps for the generative-retrieval decoder (counterpart
of rqvae_tpu/train/train_decoder.py: its config, the flat and the
length-bucketed train steps).

The entry points are the step functions, as ``bench.py`` drives them:

* ``make_train_step(model_cfg, opt, index, accum, compute_dtype, sem_dim)``
  returns ``step(params, opt_state, batch, generator)`` over a ``SeqBatch``
  whose tensors carry a leading ``accum`` axis; it tokenizes, runs the
  forward with dropout, backpropagates and applies one AdamW update.
* ``bucket_slices`` sorts a batch by history length into equal groups, each
  padded only to its own max; ``make_bucketed_fns`` returns the
  ``(grad_accum, apply)`` pair that sums the groups' gradients with weight
  1 / n_buckets and then applies one update: the flat step's gradients,
  with fewer padded tokens.
* ``make_packed_step(model_cfg, opt, index, compute_dtype)`` returns
  ``step(params, opt_state, packed, generator)`` over a packed batch
  (``data/packing.py``): several crops a row, segment-local attention
  through the span kernels, the loss meaned over the valid slots.

Mixed precision is the JAX package's: fp32 master params and AdamW state,
``amp.cast_floating(params, bf16)`` inside the differentiated loss (so the
gradients land in fp32 on the master leaves), and the fp32 islands of the
model (RMSNorm statistics, softmax, cross-entropy). Parameters and the
optimizer state are updated in place; dropout draws from the caller's
``torch.Generator`` in a fixed order.

The full ``train()`` loop (dataset pipeline, checkpoints, evals, logging)
is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from rqvae_tpu_torch.data.registry import RecDataset
from rqvae_tpu_torch.data.schemas import SeqBatch
from rqvae_tpu_torch.models import retrieval
from rqvae_tpu_torch.models.quantize import QuantizeForwardMode
from rqvae_tpu_torch.models.retrieval import RetrievalConfig
from rqvae_tpu_torch.tokenizer import semids
from rqvae_tpu_torch.utils import amp
from rqvae_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class DecoderTrainConfig:
    """The fields ``configs/decoder_*.json`` set, with the JAX package's
    defaults (the reference train() kwargs and the framework knobs)."""
    iterations: int = 500000
    batch_size: int = 64
    learning_rate: float = 0.001
    weight_decay: float = 0.01
    dataset_folder: str = "dataset/ml-1m"
    save_dir_root: str = "out/decoder/"
    dataset: RecDataset = RecDataset.ML_1M
    pretrained_rqvae_path: Optional[str] = None
    pretrained_decoder_path: Optional[str] = None
    split_batches: bool = True
    amp: bool = False
    force_dataset_process: bool = False
    mixed_precision_type: str = "bf16"
    gradient_accumulate_every: int = 1
    save_model_every: int = 1000000
    partial_eval_every: int = 1000
    full_eval_every: int = 10000
    vae_input_dim: int = 18
    vae_embed_dim: int = 16
    vae_hidden_dims: Tuple[int, ...] = (18, 18)
    vae_codebook_size: int = 32
    vae_codebook_normalize: bool = False
    vae_codebook_mode: QuantizeForwardMode = QuantizeForwardMode.GUMBEL_SOFTMAX
    vae_sim_vq: bool = False
    vae_n_cat_feats: int = 18
    vae_n_layers: int = 3
    decoder_embed_dim: int = 64
    dropout_p: float = 0.1
    attn_heads: int = 8
    attn_embed_dim: int = 64
    attn_layers: int = 4
    dataset_split: str = "beauty"
    train_data_subsample: bool = True
    # length-bucketed gradient accumulation (1 = off); see bucket_slices
    length_buckets: int = 1
    # packed long-context training (data/packing.py, make_packed_step):
    # rows per step (0 = off) and segments per row
    packed_rows: int = 0
    pack_slots: int = 8
    seed: int = 42
    log_every: int = 100
    warmup_steps: int = 10000
    eval_batches: int = 32
    generation_top_k: int = 32
    generation_candidates: int = 200
    generation_temperature: float = 1.0
    synthetic_n_items: int = 2048
    synthetic_n_users: int = 2048
    data_path: Optional[str] = None

    def retrieval_config(self, max_seq_len: int) -> RetrievalConfig:
        sem_dim = self.vae_n_layers + 1
        return RetrievalConfig(
            embedding_dim=self.decoder_embed_dim, attn_dim=self.attn_embed_dim,
            dropout=self.dropout_p, num_heads=self.attn_heads, n_layers=self.attn_layers,
            num_embeddings=self.vae_codebook_size, sem_id_dim=sem_dim,
            max_pos=max_seq_len * sem_dim,
        )


def value_and_grad(loss_fn, params, *args):
    """(loss, aux, grads) of ``loss_fn(params, *args) -> (loss, aux)``, aux
    a tensor or a tree of tensors, detached; ``grads`` has the params'
    structure (zeros for a leaf the loss does not reach). The params' own
    tensors are not marked for autograd."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    loss, aux = loss_fn(tree_unflatten(params, leaves), *args)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, leaves)]
    return loss.detach(), tree_map(lambda t: t.detach(), aux), tree_unflatten(params, grads)


def _make_microbatch_loss(model_cfg: RetrievalConfig, index: semids.CorpusIndex,
                          compute_dtype: torch.dtype):
    """The one training loss, shared by the flat and the bucketed steps."""

    def microbatch_loss(params, batch: SeqBatch, generator: Optional[torch.Generator]):
        p = amp.cast_floating(params, compute_dtype)  # inside the loss: fp32 grads
        tok = semids.tokenize_sequences(index, batch)
        out = retrieval.forward(p, model_cfg, tok, training=True, generator=generator)
        return out.loss, out.loss_d

    return microbatch_loss


def _apply_updates(opt, params, opt_state, grads):
    return params, opt.update(params, opt_state, grads)


def make_bucketed_fns(model_cfg: RetrievalConfig, opt, index: semids.CorpusIndex,
                      compute_dtype: torch.dtype, sem_dim: int):
    """(grad_accum, apply) for length-bucketed training. ``grad_accum`` adds
    ``w`` times one group's gradients into ``grads_acc`` in place; ``apply``
    is the single optimizer update."""
    microbatch_loss = _make_microbatch_loss(model_cfg, index, compute_dtype)

    def grad_accum(params, grads_acc, loss_acc, loss_d_acc, batch: SeqBatch,
                   generator: Optional[torch.Generator], w: float):
        loss, loss_d, grads = value_and_grad(microbatch_loss, params, batch, generator)
        torch._foreach_add_(tree_leaves(grads_acc), tree_leaves(grads), alpha=w)
        return grads_acc, loss_acc + w * loss, loss_d_acc + w * loss_d

    def apply(params, opt_state, grads):
        return _apply_updates(opt, params, opt_state, grads)

    return grad_accum, apply


def bucket_slices(lengths: np.ndarray, n_buckets: int, grid: int = 4):
    """Sort rows by length desc, split into equal groups, quantize each
    group's pad length to the grid. Returns [(row indices, pad length)]."""
    order = np.argsort(-lengths, kind="stable")
    groups = np.split(order, n_buckets)
    out = []
    for rows in groups:
        lmax = max(1, int(lengths[rows].max()))
        out.append((rows, int(np.ceil(lmax / grid) * grid)))
    return out


def make_packed_step(model_cfg: RetrievalConfig, opt, index: semids.CorpusIndex,
                     compute_dtype: torch.dtype):
    """``step(params, opt_state, packed, generator) -> (params, opt_state,
    metrics)`` over a packed batch (``data.packing.PackedSeqBatch`` of
    tensors, ``packing.to_device``): tokenize, the segment-local forward
    with dropout, backpropagate, one AdamW update. The same loss estimator
    as the flat step, over the examples the packer placed."""

    def packed_loss(params, packed, generator: Optional[torch.Generator]):
        p = amp.cast_floating(params, compute_dtype)  # inside the loss: fp32 grads
        tok = semids.tokenize_packed(index, packed)
        out = retrieval.forward_packed(p, model_cfg, tok, training=True, generator=generator)
        return out.loss, out.loss_d

    def step(params, opt_state, packed, generator: Optional[torch.Generator]):
        loss, loss_d, grads = value_and_grad(packed_loss, params, packed, generator)
        params, opt_state = _apply_updates(opt, params, opt_state, grads)
        return params, opt_state, {"total_loss": loss, "loss_d": loss_d}

    return step


def make_train_step(model_cfg: RetrievalConfig, opt, index: semids.CorpusIndex, accum: int,
                    compute_dtype: torch.dtype, sem_dim: int):
    """``step(params, opt_state, batch, generator) -> (params, opt_state,
    metrics)``; ``batch`` tensors are (accum, B, ...), gradients are meaned
    over the ``accum`` micro-batches (a loop, where JAX scans)."""
    microbatch_loss = _make_microbatch_loss(model_cfg, index, compute_dtype)

    def step(params, opt_state, batch: SeqBatch, generator: Optional[torch.Generator]):
        if accum == 1:
            loss, loss_d, grads = value_and_grad(microbatch_loss, params,
                                                 tree_map(lambda x: x[0], batch), generator)
        else:
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            loss = torch.zeros((), dtype=torch.float32, device=batch.ids.device)
            loss_d = torch.zeros((sem_dim,), dtype=torch.float32, device=batch.ids.device)
            for i in range(accum):
                one = tree_map(lambda x, i=i: x[i], batch)
                l, ld, g = value_and_grad(microbatch_loss, params, one, generator)
                torch._foreach_add_(tree_leaves(grads), tree_leaves(g))
                loss, loss_d = loss + l, loss_d + ld
            torch._foreach_div_(tree_leaves(grads), float(accum))
        params, opt_state = _apply_updates(opt, params, opt_state, grads)
        return params, opt_state, {"total_loss": loss / accum, "loss_d": loss_d / accum}

    return step
