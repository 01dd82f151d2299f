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

``train(cfg, device=...)`` is the entry point users call (``python -m
rqvae_tpu_torch.train.train_decoder <config> [key=value ...]``, on the GPU):
it loads the frozen RQ-VAE from a port stage-1 checkpoint
(``load_frozen_rqvae``), tokenizes the corpus, trains through the flat,
bucketed or packed step, logs eval loss every ``partial_eval_every`` steps
and constrained-beam-search hit rates (``run_generative_eval``) every
``full_eval_every`` steps and at the end, checkpoints, and resumes from
``save_dir_root`` with JAX's semantics: ``iterations`` counts from the
resume point. With ``push_vae_to_hf`` it exports the frozen RQ-VAE to
``<save_dir_root>/rqvae_export`` (``models/io.save_pretrained``) and pushes
it to the hub (rank 0) before the first step. Under ``torchrun`` it runs
over a (data, model) mesh (``parallel/mesh``, ``mesh_shape``; default all
ranks on ``data``): each data replica samples its block of the global batch
and draws its dropout from a generator seeded by its data coordinate,
gradients are all-reduced once a step over the data group, metrics are
reduced over it, and rank 0 writes the checkpoints. With
``tensor_parallel=True`` and a model axis above 1 the parameters and their
Adam moments are split by JAX's Megatron rules (``mesh.retrieval_tp_spec``)
after init or restore, every step and eval runs on the shards
(``parallel/tensor``; heads that do not divide over the model axis keep the
attention whole on every rank, ``mesh.leaf_spec``), and checkpoints are
gathered to the whole layout, so they restore into any mesh. ``profile_dir`` traces a step window
(``utils/profiling``), ``metrics_sink="tensorboard"`` adds an event stream
and ``debug_nans`` raises ``FloatingPointError`` at the first non-finite
step.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import time
from typing import Optional, Tuple

import numpy as np
import torch

from rqvae_tpu_torch.data import dataset as dataset_lib
from rqvae_tpu_torch.data import registry
from rqvae_tpu_torch.data.registry import RecDataset
from rqvae_tpu_torch.data.schemas import SeqBatch
from rqvae_tpu_torch.evaluate.metrics import TopKAccumulator, batch_hit_counts
from rqvae_tpu_torch.models import generation, retrieval
from rqvae_tpu_torch.models import rqvae as rqvae_lib
from rqvae_tpu_torch.models.quantize import QuantizeForwardMode
from rqvae_tpu_torch.models.retrieval import RetrievalConfig
from rqvae_tpu_torch.ops import dispatch
from rqvae_tpu_torch.parallel import mesh as mesh_lib
from rqvae_tpu_torch.tokenizer import semids
from rqvae_tpu_torch.train import checkpoint as ckpt_lib
from rqvae_tpu_torch.train import optim
from rqvae_tpu_torch.utils import amp
from rqvae_tpu_torch.utils import config as config_lib
from rqvae_tpu_torch.utils.device import resolve_device
from rqvae_tpu_torch.utils.logging import MetricsLogger
from rqvae_tpu_torch.utils.profiling import StepProfiler
from rqvae_tpu_torch.utils.tree import (tree_leaves, tree_leaves_with_path, tree_map, tree_shapes,
                                        tree_unflatten)


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
    push_vae_to_hf: bool = False                 # export + hub push of the frozen RQ-VAE
    vae_hf_model_name: Optional[str] = None
    # length-bucketed gradient accumulation (1 = off); see bucket_slices
    length_buckets: int = 1
    # packed long-context training (data/packing.py, make_packed_step):
    # rows per step (0 = off) and segments per row
    packed_rows: int = 0
    pack_slots: int = 8
    seed: int = 42
    prng_impl: str = "rbg"                       # a JAX PRNG choice; unused here
    log_every: int = 100
    metrics_sink: str = "jsonl"                  # or "tensorboard"
    tensorboard_dir: Optional[str] = None
    warmup_steps: int = 10000
    eval_batches: int = 32
    generation_top_k: int = 32
    generation_candidates: int = 200
    generation_temperature: float = 1.0
    mesh_shape: Optional[Tuple[int, ...]] = None   # (data, model); default (world, 1)
    tensor_parallel: bool = False                  # split the params over 'model'
    synthetic_n_items: int = 2048
    synthetic_n_users: int = 2048
    data_path: Optional[str] = None
    profile_dir: Optional[str] = None
    profile_start: int = 10
    profile_steps: int = 5
    # resume from the latest checkpoint under save_dir_root when no
    # pretrained decoder path is given; `iterations` then counts steps FROM
    # THE RESUME POINT (rerunning a finished run trains `iterations` more)
    auto_resume: bool = True
    debug_nans: bool = False

    def vae_config(self) -> rqvae_lib.RqVaeConfig:
        return rqvae_lib.RqVaeConfig(
            input_dim=self.vae_input_dim, embed_dim=self.vae_embed_dim,
            hidden_dims=self.vae_hidden_dims, codebook_size=self.vae_codebook_size,
            n_layers=self.vae_n_layers, n_cat_feats=self.vae_n_cat_feats,
            codebook_mode=self.vae_codebook_mode, codebook_normalize=self.vae_codebook_normalize,
            codebook_sim_vq=self.vae_sim_vq, codebook_kmeans_init=False,
        )

    def retrieval_config(self, max_seq_len: int) -> RetrievalConfig:
        sem_dim = self.vae_n_layers + 1
        return RetrievalConfig(
            embedding_dim=self.decoder_embed_dim, attn_dim=self.attn_embed_dim,
            dropout=self.dropout_p, num_heads=self.attn_heads, n_layers=self.attn_layers,
            num_embeddings=self.vae_codebook_size, sem_id_dim=sem_dim,
            max_pos=max_seq_len * sem_dim,
        )


def _every(it: int, interval: int) -> bool:
    """True on steps where a periodic action (log / eval / save) fires;
    interval <= 0 turns the action off."""
    return interval > 0 and (it + 1) % interval == 0


def debug_metrics(seq_mask: np.ndarray, prefix: str, token_scale: int = 1) -> dict:
    """Sequence-length quantiles of a (B, N) mask, in tokens when the mask is
    in items and ``token_scale`` is sem_id_dim (the reference's logging)."""
    lengths = np.asarray(seq_mask).sum(axis=-1).astype(np.float32).ravel() * token_scale
    return _length_quantiles(lengths, prefix)


def _length_quantiles(lengths: np.ndarray, prefix: str) -> dict:
    return {f"{prefix}_seq_length_p{q}": float(np.quantile(lengths, q))
            for q in (0.25, 0.5, 0.75, 0.9, 1)}


def load_frozen_rqvae(cfg: DecoderTrainConfig, *, device=None):
    """Stage-1 -> stage-2 handoff: (params, RqVaeConfig) of the frozen
    RQ-VAE, restored from the latest step of a port stage-1 checkpoint
    (``train_rqvae.train``'s ``save_dir_root``) and detached. Without
    ``pretrained_rqvae_path`` the params are random from seed 0, as in JAX."""
    dev = resolve_device(device)
    vae_cfg = cfg.vae_config()
    params = rqvae_lib.init(torch.Generator().manual_seed(0), vae_cfg, device=dev)
    if cfg.pretrained_rqvae_path is not None:
        state, meta = ckpt_lib.restore(cfg.pretrained_rqvae_path, device=dev)
        if tree_shapes(state["params"]) != tree_shapes(params):
            raise ValueError(f"the RQ-VAE checkpoint at {cfg.pretrained_rqvae_path} does not fit "
                             f"the config's RQ-VAE ({vae_cfg})")
        params = state["params"]
        print(f"---Loaded RQVAE Iter {meta['step']}---", file=sys.stderr)
    return tree_map(lambda t: t.detach(), params), vae_cfg


def value_and_grad(loss_fn, params, *args, debug_nans: bool = False):
    """(loss, aux, grads) of ``loss_fn(params, *args) -> (loss, aux)``, aux
    a tensor or a tree of tensors, detached; ``grads`` has the params'
    structure (zeros for a leaf the loss does not reach). The params' own
    tensors are not marked for autograd. ``debug_nans`` runs forward and
    backward under ``torch.autograd.detect_anomaly(check_nan=True)`` and
    turns its NaN error into ``FloatingPointError``."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    with (torch.autograd.detect_anomaly(check_nan=True) if debug_nans
          else contextlib.nullcontext()):
        loss, aux = loss_fn(tree_unflatten(params, leaves), *args)
        try:
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        except RuntimeError as e:
            if debug_nans and "nan values" in str(e):
                raise FloatingPointError(
                    f"NaN in the backward (loss {float(loss.detach())}): {e}") from e
            raise
    grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, leaves)]
    return loss.detach(), tree_map(lambda t: t.detach(), aux), tree_unflatten(params, grads)


def check_finite(grads, loss: Optional[torch.Tensor] = None) -> None:
    """``debug_nans``' per-step check, one host sync: raises
    ``FloatingPointError`` naming the loss or the first gradient leaf (by
    path) that holds a NaN or an infinity."""
    named = ([] if loss is None else [("loss", loss)]) + [
        ("gradient " + "/".join(map(str, path)), g) for path, g in tree_leaves_with_path(grads)]
    ok = torch.stack([torch.isfinite(t).all() for _, t in named]).cpu()
    if not bool(ok.all()):
        raise FloatingPointError(f"non-finite {named[int((~ok).nonzero()[0])][0]}")


def _make_microbatch_loss(model_cfg: RetrievalConfig, index: semids.CorpusIndex,
                          compute_dtype: torch.dtype):
    """The one training loss, shared by the flat and the bucketed steps."""

    def microbatch_loss(params, batch: SeqBatch, generator: Optional[torch.Generator]):
        p = amp.cast_floating(params, compute_dtype)  # inside the loss: fp32 grads
        tok = semids.tokenize_sequences(index, batch)
        out = retrieval.forward(p, model_cfg, tok, training=True, generator=generator)
        return out.loss, out.loss_d

    return microbatch_loss


def _apply_updates(opt, params, opt_state, grads, op: str = "mean", loss=None,
                   debug_nans: bool = False):
    """Reduce the gradients over the data replicas (``op``; an identity on
    one device), check them under ``debug_nans``, then one AdamW update."""
    mesh_lib.all_reduce_(tree_leaves(grads), op)
    if debug_nans:
        check_finite(grads, loss)
    return params, opt.update(params, opt_state, grads)


def make_bucketed_fns(model_cfg: RetrievalConfig, opt, index: semids.CorpusIndex,
                      compute_dtype: torch.dtype, sem_dim: int, *, debug_nans: bool = False):
    """(grad_accum, apply) for length-bucketed training. ``grad_accum`` adds
    ``w`` times one group's gradients into ``grads_acc`` in place; ``apply``
    is the single optimizer update, after the gradients' mean over the data
    replicas (each rank buckets its own rows)."""
    microbatch_loss = _make_microbatch_loss(model_cfg, index, compute_dtype)

    def grad_accum(params, grads_acc, loss_acc, loss_d_acc, batch: SeqBatch,
                   generator: Optional[torch.Generator], w: float):
        loss, loss_d, grads = value_and_grad(microbatch_loss, params, batch, generator,
                                             debug_nans=debug_nans)
        torch._foreach_add_(tree_leaves(grads_acc), tree_leaves(grads), alpha=w)
        return grads_acc, loss_acc + w * loss, loss_d_acc + w * loss_d

    def apply(params, opt_state, grads, loss=None):
        return _apply_updates(opt, params, opt_state, grads, loss=loss, debug_nans=debug_nans)

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
                     compute_dtype: torch.dtype, *, debug_nans: bool = False):
    """``step(params, opt_state, packed, generator) -> (params, opt_state,
    metrics)`` over a packed batch (``data.packing.PackedSeqBatch`` of
    tensors, ``packing.to_device``): tokenize, the segment-local forward
    with dropout, backpropagate, one AdamW update. The same loss estimator
    as the flat step, over the examples the packer placed. Under data
    parallelism the loss is divided by the replicas' summed valid slots and
    the gradients are summed: the global loss over the global slots, as
    JAX's GSPMD step computes it; each rank's ``total_loss`` is its share."""

    def packed_loss(params, packed, generator: Optional[torch.Generator]):
        p = amp.cast_floating(params, compute_dtype)  # inside the loss: fp32 grads
        tok = semids.tokenize_packed(index, packed)
        n_valid = mesh_lib.all_reduce_sum(torch.sum(tok.slot_valid))
        out = retrieval.forward_packed(p, model_cfg, tok, training=True, generator=generator,
                                       n_valid=n_valid)
        return out.loss, out.loss_d

    def step(params, opt_state, packed, generator: Optional[torch.Generator]):
        loss, loss_d, grads = value_and_grad(packed_loss, params, packed, generator,
                                             debug_nans=debug_nans)
        params, opt_state = _apply_updates(opt, params, opt_state, grads, "sum", loss,
                                           debug_nans)
        return params, opt_state, {"total_loss": loss, "loss_d": loss_d}

    return step


def make_train_step(model_cfg: RetrievalConfig, opt, index: semids.CorpusIndex, accum: int,
                    compute_dtype: torch.dtype, sem_dim: int, *, debug_nans: bool = False):
    """``step(params, opt_state, batch, generator) -> (params, opt_state,
    metrics)``; ``batch`` tensors are (accum, B, ...), gradients are meaned
    over the ``accum`` micro-batches (a loop, where JAX scans) and over the
    data replicas (``parallel/mesh``; none on one device)."""
    microbatch_loss = _make_microbatch_loss(model_cfg, index, compute_dtype)

    def step(params, opt_state, batch: SeqBatch, generator: Optional[torch.Generator]):
        if accum == 1:
            loss, loss_d, grads = value_and_grad(microbatch_loss, params,
                                                 tree_map(lambda x: x[0], batch), generator,
                                                 debug_nans=debug_nans)
        else:
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            loss = torch.zeros((), dtype=torch.float32, device=batch.ids.device)
            loss_d = torch.zeros((sem_dim,), dtype=torch.float32, device=batch.ids.device)
            for i in range(accum):
                one = tree_map(lambda x, i=i: x[i], batch)
                l, ld, g = value_and_grad(microbatch_loss, params, one, generator,
                                          debug_nans=debug_nans)
                torch._foreach_add_(tree_leaves(grads), tree_leaves(g))
                loss, loss_d = loss + l, loss_d + ld
            torch._foreach_div_(tree_leaves(grads), float(accum))
        params, opt_state = _apply_updates(opt, params, opt_state, grads, "mean", loss,
                                           debug_nans)
        return params, opt_state, {"total_loss": loss / accum, "loss_d": loss_d / accum}

    return step


def make_generative_eval_fns(model_cfg: RetrievalConfig, index: semids.CorpusIndex,
                             cfg: DecoderTrainConfig, ks):
    """(generate_fn, hit_counts_fn), the pair the full eval drives:
    ``generate_fn(params, batch, generator) -> (GenerationOutput, actual
    sem-ID tuples)`` runs the constrained beam search on a ``SeqBatch`` of
    tensors; ``hit_counts_fn(actual, top_k, valid) -> (counts, n_valid)``
    counts hits on the rows with ``valid`` True."""

    def generate_fn(params, batch: SeqBatch, generator: Optional[torch.Generator]):
        tok = semids.tokenize_sequences(index, batch)
        gen = generation.generate_next_sem_ids(
            params, model_cfg, index, tok._replace(sem_ids_fut=None, token_type_ids_fut=None),
            generator, k=cfg.generation_top_k, n_candidates=cfg.generation_candidates,
            temperature=cfg.generation_temperature)
        return gen, tok.sem_ids_fut

    def hit_counts_fn(actual, top_k, valid):
        return batch_hit_counts(actual, top_k, ks, valid=valid), torch.sum(valid)

    return generate_fn, hit_counts_fn


def run_generative_eval(params, model_cfg: RetrievalConfig, index: semids.CorpusIndex,
                        seqs: dataset_lib.SeqDataset, items: dataset_lib.ItemDataset,
                        cfg: DecoderTrainConfig, generator: Optional[torch.Generator], *,
                        n_eval: int, eval_fns=None) -> dict:
    """Constrained-beam-search eval over the first ``n_eval`` rows of
    ``seqs``: batches of ``cfg.batch_size`` rows, the last padded with copies
    of the final row (one batch shape, as in JAX) whose counts are masked
    out; hit rates reduced on the host (``TopKAccumulator``). Under data
    parallelism each replica searches its block of every batch
    (``mesh.host_block``) and the hit counts and row totals are summed over
    the data group before the rates, so every rank reports the same metrics;
    under tensor parallelism a model group searches its block together, on
    its shards.
    ``generator`` draws the candidate noise when ``generation_candidates`` is
    below the codebook size (None is enough for the exhaustive branch)."""
    dev = index.cached_ids.device
    acc = TopKAccumulator(ks=(1, 5, 10))
    generate_fn, hit_counts_fn = eval_fns or make_generative_eval_fns(model_cfg, index, cfg,
                                                                      acc.ks)
    local_bs = mesh_lib.process_local_batch_size(cfg.batch_size)
    n_eval = min(n_eval, len(seqs))
    for lo in range(0, n_eval, cfg.batch_size):
        global_idx = np.arange(lo, lo + cfg.batch_size)
        valid = mesh_lib.host_block(global_idx < min(lo + cfg.batch_size, n_eval), local_bs)
        idx = mesh_lib.host_block(np.minimum(global_idx, n_eval - 1), local_bs)
        b = dataset_lib.to_device(
            dataset_lib.make_seq_batch(seqs.batch_at(idx), items.x, with_features=False), dev)
        gen, actual = generate_fn(params, b, generator)
        counts, n_rows = hit_counts_fn(actual, gen.sem_ids, torch.from_numpy(valid).to(dev))
        acc.accumulate_counts({k: float(v) for k, v in counts.items()}, int(n_rows))
    if mesh_lib.data_parallel():
        keys = sorted(acc.metrics)
        sums = torch.tensor([acc.metrics[k] for k in keys] + [acc.total], dtype=torch.float64,
                            device=dev)
        sums = mesh_lib.all_reduce_([sums], "sum")[0].tolist()
        acc.metrics, acc.total = dict(zip(keys, sums[:-1])), int(sums[-1])
    return acc.reduce()


def _replicated(metrics: dict, op: str) -> dict:
    """The step's metrics reduced over the data replicas (one collective;
    none on one device), so every rank logs the same values."""
    vals = [v.float() for v in metrics.values()]
    return dict(zip(metrics, mesh_lib.all_reduce_(vals, op)))


def train(cfg: DecoderTrainConfig, *, logger: Optional[MetricsLogger] = None, device=None):
    """Stage-2 training on ``device`` (cuda unless told otherwise; under
    ``torchrun``, this rank's GPU), over the (data, model) mesh of the
    process group ``torchrun`` describes; returns the trained params (the
    rank's shards under tensor parallelism)."""
    dev = resolve_device(device)
    mesh_lib.maybe_init_distributed(dev)
    logger = logger or MetricsLogger(every=cfg.log_every, sink=cfg.metrics_sink,
                                     tensorboard_dir=cfg.tensorboard_dir)
    compute_dtype = torch.bfloat16 if cfg.amp else torch.float32

    bundle = registry.load(
        cfg.dataset,
        cfg.data_path or cfg.dataset_folder,
        split=cfg.dataset_split if cfg.dataset == RecDataset.AMAZON else None,
        synthetic_kwargs={"n_items": cfg.synthetic_n_items, "feature_dim": cfg.vae_input_dim,
                          "n_users": cfg.synthetic_n_users, "seed": cfg.seed},
    )
    model_cfg = cfg.retrieval_config(bundle.max_seq_len)
    sem_dim = model_cfg.sem_id_dim
    items_x = bundle.items.x

    mesh_lib.make_mesh(cfg.mesh_shape, cfg.tensor_parallel)
    rank = mesh_lib.rank()
    data_index = mesh_lib.data_index()
    local_bs = mesh_lib.process_local_batch_size(cfg.batch_size)
    vae_params, vae_cfg = load_frozen_rqvae(cfg, device=dev)
    with dispatch.local_execution():   # the whole frozen RQ-VAE on every rank
        index = semids.precompute_corpus_ids(
            vae_params, vae_cfg,
            torch.from_numpy(dataset_lib.features_for_model(items_x, vae_cfg.input_dim)).to(dev))
    if cfg.push_vae_to_hf and rank == 0:
        from rqvae_tpu_torch.models import io as model_io

        export_dir = os.path.join(cfg.save_dir_root, "rqvae_export")
        model_io.save_pretrained(export_dir, vae_params, vae_cfg)
        url = model_io.push_to_hub(export_dir, cfg.vae_hf_model_name or "rqvae-tpu-tokenizer")
        print(f"pushed frozen RQ-VAE to {url}", file=sys.stderr)
    del vae_params
    max_dup = semids.max_duplicates(index)
    if max_dup >= cfg.vae_codebook_size:
        print(f"WARNING: max dedup rank {max_dup} >= codebook size {cfg.vae_codebook_size}; "
              "the dedup dimension overflows the sem-ID embedding range — train the RQ-VAE "
              "further.", file=sys.stderr)

    params = retrieval.init(torch.Generator().manual_seed(cfg.seed), model_cfg, device=dev)
    schedule = optim.inv_sqrt_schedule(cfg.learning_rate, cfg.warmup_steps)
    opt = optim.adamw(schedule, cfg.weight_decay)
    opt_state = opt.init(params)
    start_iter = 0
    resume_path = cfg.pretrained_decoder_path
    if resume_path is None and cfg.auto_resume and ckpt_lib.latest_step(cfg.save_dir_root) is not None:
        resume_path = cfg.save_dir_root
    if resume_path is not None:
        state, meta = ckpt_lib.restore(resume_path, device=dev)
        params, opt_state = state["params"], state["opt_state"]
        start_iter = meta["step"] + 1
    mesh_lib.broadcast_(tree_leaves(params))
    # the rank's shards of the whole tree (itself without tensor parallelism)
    state = mesh_lib.shard_state({"params": params, "opt_state": opt_state},
                                 mesh_lib.retrieval_tp_spec, model_cfg.num_heads)
    params, opt_state = state["params"], state["opt_state"]
    del state

    accum = max(1, cfg.gradient_accumulate_every)
    bs = cfg.batch_size
    use_buckets = cfg.length_buckets > 1 and accum == 1 and local_bs % cfg.length_buckets == 0
    if cfg.length_buckets > 1 and not use_buckets:
        print(f"WARNING: length_buckets={cfg.length_buckets} ignored (requires "
              "gradient_accumulate_every=1 and a per-process batch size divisible by it; "
              f"local batch={local_bs}, accum={accum}) — training takes the flat step.",
              file=sys.stderr)
    if use_buckets:
        grad_accum_fn, apply_fn = make_bucketed_fns(model_cfg, opt, index, compute_dtype, sem_dim,
                                                    debug_nans=cfg.debug_nans)
    use_packing = cfg.packed_rows > 0 and accum == 1 and not use_buckets
    if cfg.packed_rows > 0 and not use_packing:
        print(f"WARNING: packed_rows={cfg.packed_rows} ignored (requires "
              f"gradient_accumulate_every=1 and length_buckets=1; accum={accum}, "
              f"length_buckets={cfg.length_buckets}) — training takes the flat step.",
              file=sys.stderr)
    if use_packing:
        from rqvae_tpu_torch.data import packing as packing_lib

        packed_step_fn = make_packed_step(model_cfg, opt, index, compute_dtype,
                                          debug_nans=cfg.debug_nans)
    step_fn = make_train_step(model_cfg, opt, index, accum, compute_dtype, sem_dim,
                              debug_nans=cfg.debug_nans)

    def eval_loss_fn(p, batch: SeqBatch):
        with torch.no_grad():
            out = retrieval.forward(p, model_cfg, semids.tokenize_sequences(index, batch))
        return out.loss

    eval_fns = make_generative_eval_fns(model_cfg, index, cfg, (1, 5, 10))
    # per-replica streams: each data replica samples its block of the global
    # batch and draws its own dropout; a model group's ranks draw alike
    host_rng = np.random.default_rng(cfg.seed + data_index)
    # one device generator: dropout in the steps, candidate noise in the evals
    gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1 + data_index)
    seq_batch = lambda raw: dataset_lib.make_seq_batch(raw, items_x, with_features=False)  # noqa: E731
    if use_packing:
        packer = packing_lib.SequencePacker(
            seqs=bundle.train_seqs, rng=host_rng,
            rows=mesh_lib.process_local_batch_size(cfg.packed_rows), slots=cfg.pack_slots,
            subsample=cfg.train_data_subsample)
    profiler = StepProfiler(cfg.profile_dir, cfg.profile_start, cfg.profile_steps, device=dev)
    t_start = time.monotonic()
    examples_seen = 0   # this rank's own examples when packing, else the global count

    for it in range(start_iter, start_iter + cfg.iterations):
        profiler.step(it - start_iter)
        train_len_metrics = None
        try:
            if use_packing:
                raw, n_ex = packer.next_batch()
                train_len_metrics = _length_quantiles(
                    (raw.slot_len[raw.slot_valid] * sem_dim).astype(np.float32), "train")
                params, opt_state, metrics = packed_step_fn(
                    params, opt_state, packing_lib.to_device(raw, dev), gen)
                examples_seen += n_ex
            elif use_buckets:
                raw = bundle.train_seqs.sample_batch(host_rng, local_bs,
                                                     subsample=cfg.train_data_subsample)
                log_mask = raw["ids"] >= 0
                grads = tree_map(torch.zeros_like, params)
                loss_acc = torch.zeros((), device=dev)
                loss_d_acc = torch.zeros((sem_dim,), device=dev)
                for rows, length in bucket_slices(log_mask.sum(axis=1), cfg.length_buckets):
                    sub = {"user_ids": raw["user_ids"][rows], "ids": raw["ids"][rows, :length],
                           "ids_fut": raw["ids_fut"][rows]}
                    grads, loss_acc, loss_d_acc = grad_accum_fn(
                        params, grads, loss_acc, loss_d_acc,
                        dataset_lib.to_device(seq_batch(sub), dev), gen, 1.0 / cfg.length_buckets)
                params, opt_state = apply_fn(params, opt_state, grads, loss_acc)
                metrics = {"total_loss": loss_acc, "loss_d": loss_d_acc}
            else:
                host = [seq_batch(bundle.train_seqs.sample_batch(
                    host_rng, local_bs, subsample=cfg.train_data_subsample)) for _ in range(accum)]
                stacked = SeqBatch(*(np.stack(xs) for xs in zip(*host)))
                log_mask = stacked.seq_mask
                params, opt_state, metrics = step_fn(params, opt_state,
                                                     dataset_lib.to_device(stacked, dev), gen)
        except FloatingPointError as e:
            raise FloatingPointError(f"step {it + 1}: {e}") from e
        if not use_packing:
            examples_seen += accum * bs

        if _every(it, cfg.log_every) or it == start_iter:
            # packed: each rank's loss is its share of the global loss
            metrics = _replicated(metrics, "sum" if use_packing else "mean")
            m = {k: v.cpu().numpy() for k, v in metrics.items()}
            loss_d = m.pop("loss_d")
            m.update({f"loss_{d}": loss_d[d] for d in range(sem_dim)})
            m["learning_rate"] = float(schedule(it + 1))
            seen = examples_seen
            if use_packing:   # the exact global count
                seen = int(mesh_lib.all_reduce_sum(torch.tensor(examples_seen, device=dev)))
            m["examples_per_s"] = seen / (time.monotonic() - t_start)
            m.update(train_len_metrics if train_len_metrics is not None
                     else debug_metrics(log_mask, "train", sem_dim))
            logger.log(it + 1, m, force=True)

        last = it + 1 == start_iter + cfg.iterations
        n_eval_rows = len(bundle.eval_seqs) if bundle.eval_seqs is not None else 0
        if n_eval_rows and (_every(it, cfg.partial_eval_every) or last):
            losses, eval_mask = [], None
            for eb in range(min(cfg.eval_batches, max(1, n_eval_rows // bs))):
                # small eval sets wrap modulo the set: near-uniform repeats,
                # one batch shape; each rank evaluates its block
                global_idx = np.arange(eb * bs, (eb + 1) * bs) % n_eval_rows
                b = seq_batch(bundle.eval_seqs.batch_at(mesh_lib.host_block(global_idx, local_bs)))
                losses.append(eval_loss_fn(params, dataset_lib.to_device(b, dev)))
                eval_mask = b.seq_mask
            ev = mesh_lib.all_reduce_([torch.stack(losses).double()], "mean")[0]
            logger.log(it + 1, {"eval_loss": float(ev.mean()),
                                **debug_metrics(eval_mask, "eval", sem_dim)}, force=True)

        if n_eval_rows and (_every(it, cfg.full_eval_every) or last):
            logger.log(it + 1, run_generative_eval(
                params, model_cfg, index, bundle.eval_seqs, bundle.items, cfg, gen,
                n_eval=min(cfg.eval_batches * bs, n_eval_rows), eval_fns=eval_fns), force=True)

        if _every(it, cfg.save_model_every) or last:
            ckpt_lib.save(cfg.save_dir_root, it, {"params": params, "opt_state": opt_state},
                          meta={"config": config_lib.config_to_dict(cfg)},
                          spec_fn=mesh_lib.retrieval_tp_spec, heads=model_cfg.num_heads)
    profiler.close()
    return params


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    path = argv[0] if argv and "=" not in argv[0] else None
    overrides = argv[1:] if path else argv
    cfg = config_lib.load_config(DecoderTrainConfig, path, overrides)
    train(cfg)


if __name__ == "__main__":
    main()
