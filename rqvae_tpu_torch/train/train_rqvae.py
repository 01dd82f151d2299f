"""Stage-1 training: the RQ-VAE tokenizer (counterpart of
rqvae_tpu/train/train_rqvae.py).

* ``RqVaeTrainConfig``: every field and default of the JAX config, read from
  the same ``configs/rqvae_*.json`` files by ``utils/config.load_config``.
* ``make_train_step(model_cfg, opt, accum, compute_dtype)`` returns
  ``step(params, opt_state, x, generator, gumbel_t)`` over x (accum, B, D):
  forward, backward and one AdamW update; gradients are meaned over the
  ``accum`` micro-batches (a loop, where JAX scans).
* ``make_device_chunk`` runs ``n_steps`` such steps per call on a corpus
  that lives on the device: batch indices are drawn on the device from the
  caller's generator, nothing syncs with the host inside the chunk, and the
  metrics come back as device tensors averaged over the chunk's steps.
* ``make_eval_step`` and ``id_diversity_metrics`` (corpus re-tokenization
  through ``rq_tokenize``: entropy, codebook usage, max id duplicates).
* ``train(cfg)``: k-means priming at step 0, the host-fed loop
  (``steps_per_call == 1``) or the device-resident chunks, eval, JSONL
  metrics, checkpoints and auto-resume (``iterations`` counts from the
  resume point, as in JAX). ``python -m rqvae_tpu_torch.train.train_rqvae
  <config> [key=value ...]`` runs it on the GPU.

Mixed precision is the JAX package's: fp32 master params and AdamW state,
``amp.cast_floating(params, bf16)`` inside the differentiated loss, fp32
loss islands. Parameters and the optimizer state are updated in place.

Under ``torchrun`` ``train`` runs over a (data, model) mesh
(``parallel/mesh``): host batches from ``default_rng(seed + data
coordinate)``, the device chunk's global indices drawn alike on every rank
and split by columns between the data replicas, gradients all-reduced once a
step over the data group, reduced metrics, rank 0's diversity metrics and
checkpoints. With ``tensor_parallel=True`` and a model axis above 1 the
codebooks and MLPs are split by JAX's rules (``mesh.rqvae_tp_spec``) after
k-means priming, which runs on the whole parameters; the steps take the
per-level loop (no ``rq_quantize_train``), the diversity metrics run on
gathered parameters and checkpoints hold the whole layout. ``profile_dir``,
the TensorBoard sink and ``debug_nans`` work as in the decoder loop.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from typing import Optional, Tuple

import numpy as np
import torch

from rqvae_tpu_torch.data import dataset as dataset_lib
from rqvae_tpu_torch.data import registry
from rqvae_tpu_torch.models import rqvae as rqvae_lib
from rqvae_tpu_torch.models.quantize import QuantizeForwardMode
from rqvae_tpu_torch.ops import dispatch
from rqvae_tpu_torch.parallel import mesh as mesh_lib
from rqvae_tpu_torch.tokenizer import semids
from rqvae_tpu_torch.train import checkpoint as ckpt_lib
from rqvae_tpu_torch.train import optim
from rqvae_tpu_torch.train import temperature
from rqvae_tpu_torch.train.train_decoder import _every, _replicated, check_finite, value_and_grad
from rqvae_tpu_torch.utils import amp
from rqvae_tpu_torch.utils import config as config_lib
from rqvae_tpu_torch.utils.device import resolve_device
from rqvae_tpu_torch.utils import profiling
from rqvae_tpu_torch.utils.logging import MetricsLogger
from rqvae_tpu_torch.utils.profiling import StepProfiler
from rqvae_tpu_torch.utils.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class RqVaeTrainConfig:
    # ---- reference train() kwargs ----
    iterations: int = 50000
    batch_size: int = 64
    learning_rate: float = 0.0001
    weight_decay: float = 0.01
    dataset_folder: str = "dataset/ml-1m"
    dataset: registry.RecDataset = registry.RecDataset.ML_1M
    pretrained_rqvae_path: Optional[str] = None
    save_dir_root: str = "out/rqvae/"
    use_kmeans_init: bool = True
    split_batches: bool = True          # parity flag; batch_size is global
    amp: bool = False                    # bf16 compute when True
    do_eval: bool = True
    force_dataset_process: bool = False
    mixed_precision_type: str = "bf16"
    gradient_accumulate_every: int = 1
    save_model_every: int = 1000000
    eval_every: int = 50000
    commitment_weight: float = 0.25
    vae_n_cat_feats: int = 18
    vae_input_dim: int = 18
    vae_embed_dim: int = 16
    vae_hidden_dims: Tuple[int, ...] = (18, 18)
    vae_codebook_size: int = 32
    vae_codebook_normalize: bool = False
    vae_codebook_mode: QuantizeForwardMode = QuantizeForwardMode.GUMBEL_SOFTMAX
    vae_sim_vq: bool = False
    vae_n_layers: int = 3
    dataset_split: str = "beauty"
    data_path: Optional[str] = None
    # ---- framework knobs ----
    seed: int = 42
    prng_impl: str = "rbg"               # a JAX PRNG choice; unused here
    log_every: int = 100
    metrics_sink: str = "jsonl"          # or "tensorboard"
    tensorboard_dir: Optional[str] = None
    gumbel_temperature: float = 0.2
    gumbel_anneal: bool = False
    gumbel_min_t: float = 0.05
    gumbel_anneal_rate: float = 1e-5
    gumbel_anneal_step_size: int = 1000
    kmeans_prime_items: int = 20000
    eval_batches: int = 50
    # device-resident loop: the corpus lives on the device, batch indices are
    # drawn there, and this many optimizer steps run per call; 1 = the
    # host-fed loop (numpy sampling, one step per call)
    steps_per_call: int = 8
    mesh_shape: Optional[Tuple[int, ...]] = None   # (data, model); default (world, 1)
    # shard codebooks + enc/dec MLPs over the mesh 'model' axis
    tensor_parallel: bool = False
    synthetic_n_items: int = 2048
    synthetic_n_users: int = 2048
    profile_dir: Optional[str] = None
    profile_start: int = 10
    profile_steps: int = 5
    # resume from the latest checkpoint under save_dir_root when no explicit
    # pretrained path is given; `iterations` then counts steps FROM THE
    # RESUME POINT (rerunning a finished run trains `iterations` more)
    auto_resume: bool = True
    debug_nans: bool = False

    def model_config(self) -> rqvae_lib.RqVaeConfig:
        return rqvae_lib.RqVaeConfig(
            input_dim=self.vae_input_dim,
            embed_dim=self.vae_embed_dim,
            hidden_dims=self.vae_hidden_dims,
            codebook_size=self.vae_codebook_size,
            n_layers=self.vae_n_layers,
            n_cat_feats=self.vae_n_cat_feats,
            commitment_weight=self.commitment_weight,
            codebook_mode=self.vae_codebook_mode,
            codebook_normalize=self.vae_codebook_normalize,
            codebook_sim_vq=self.vae_sim_vq,
            codebook_kmeans_init=self.use_kmeans_init and self.pretrained_rqvae_path is None,
        )


def _make_microbatch_loss(model_cfg: rqvae_lib.RqVaeConfig, compute_dtype: torch.dtype):
    def microbatch_loss(params, x, generator, gumbel_t):
        p = amp.cast_floating(params, compute_dtype)  # inside the loss: fp32 grads
        out = rqvae_lib.forward(p, model_cfg, x.to(compute_dtype), gumbel_t=gumbel_t,
                                training=True, generator=generator)
        return out.loss, out

    return microbatch_loss


def make_train_step(model_cfg: rqvae_lib.RqVaeConfig, opt, accum: int,
                    compute_dtype: torch.dtype, *, debug_nans: bool = False):
    """``step(params, opt_state, x, generator, gumbel_t) -> (params,
    opt_state, metrics)``; x is (accum, B, D), metrics are device tensors.
    The gradients are meaned over the data replicas (``parallel/mesh``; none
    on one device): the losses are batch means over equal local batches, so
    that is the global batch's gradient."""
    microbatch_loss = _make_microbatch_loss(model_cfg, compute_dtype)

    def step(params, opt_state, x, generator, gumbel_t):
        dev = x.device
        if accum == 1:
            loss, out, grads = value_and_grad(microbatch_loss, params, x[0], generator, gumbel_t,
                                              debug_nans=debug_nans)
            recon, vq, pu = out.reconstruction_loss, out.rqvae_loss.float(), out.p_unique_ids
            embs_norm = out.embs_norm[None].float()
        else:
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            loss, recon, vq, pu = (torch.zeros((), device=dev) for _ in range(4))
            norms = []
            for i in range(accum):
                l, out, g = value_and_grad(microbatch_loss, params, x[i], generator, gumbel_t,
                                           debug_nans=debug_nans)
                torch._foreach_add_(tree_leaves(grads), tree_leaves(g))
                loss = loss + l
                recon = recon + out.reconstruction_loss
                vq = vq + out.rqvae_loss.float()
                pu = pu + out.p_unique_ids
                norms.append(out.embs_norm.float())
            torch._foreach_div_(tree_leaves(grads), float(accum))
            embs_norm = torch.stack(norms)
        with profiling.span("step.optimizer"):
            mesh_lib.all_reduce_(tree_leaves(grads), "mean")
            if debug_nans:
                check_finite(grads, loss)
            opt_state = opt.update(params, opt_state, grads)
        metrics = {
            "total_loss": loss / accum,
            "reconstruction_loss": recon / accum,
            "rqvae_loss": vq / accum,
            "p_unique_ids": pu / accum,
            "embs_norm_mean": torch.mean(embs_norm, dim=(0, 1)),  # (L,)
        }
        return params, opt_state, metrics

    return step


def make_device_chunk(model_cfg: rqvae_lib.RqVaeConfig, opt, accum: int,
                      compute_dtype: torch.dtype, batch_size: int, n_steps: int, *,
                      debug_nans: bool = False):
    """``chunk(params, opt_state, corpus, generator, gumbel_t,
    index_generator=None)``: ``n_steps`` optimizer steps on batches drawn on
    the device from ``corpus`` (N, D). The global (accum, ``batch_size``)
    indices come from ``index_generator`` (default ``generator``; generators
    on the corpus's device), and each data replica takes its block of
    columns (JAX's ``P(None, 'data', None)``; a model group's ranks take
    the same), so under data parallelism ``index_generator`` must be seeded
    alike on every rank; ``generator`` draws the Gumbel noise. Metrics are
    the chunk's means, still on the device."""
    base = make_train_step(model_cfg, opt, accum, compute_dtype, debug_nans=debug_nans)

    def chunk(params, opt_state, corpus, generator, gumbel_t, index_generator=None):
        local = mesh_lib.process_local_batch_size(batch_size)
        i = mesh_lib.data_index()
        cols = slice(i * local, (i + 1) * local)
        ms = []
        for _ in range(n_steps):
            idx = torch.randint(0, corpus.shape[0], (accum, batch_size), device=corpus.device,
                                generator=generator if index_generator is None else index_generator)
            params, opt_state, metrics = base(params, opt_state, corpus[idx[:, cols]], generator,
                                              gumbel_t)
            ms.append(metrics)
        return params, opt_state, {k: torch.mean(torch.stack([m[k] for m in ms]), dim=0)
                                   for k in ms[0]}

    return chunk


def make_eval_step(model_cfg: rqvae_lib.RqVaeConfig, gumbel_t: float,
                   compute_dtype: torch.dtype):
    def eval_step(params, x):
        with torch.no_grad():
            out = rqvae_lib.forward(params, model_cfg, x.to(compute_dtype), gumbel_t=gumbel_t,
                                    training=False)
        return out.loss, out.reconstruction_loss, out.rqvae_loss

    return eval_step


def id_diversity_metrics(params, model_cfg: rqvae_lib.RqVaeConfig, corpus_x: torch.Tensor) -> dict:
    """rqvae_entropy / codebook_usage_i / max_id_duplicates of the corpus's
    semantic ids (``precompute_corpus_ids``, i.e. the ``rq_tokenize``
    kernel on the GPU)."""
    index = semids.precompute_corpus_ids(params, model_cfg, corpus_x)
    cached = index.cached_ids.cpu().numpy()
    n = cached.shape[0]
    # normalized by corpus size, as the reference logs it
    out = {"max_id_duplicates": cached[:, -1].max() / n}
    _, counts = np.unique(cached[:, :-1], axis=0, return_counts=True)
    p = counts / n
    out["rqvae_entropy"] = float(-(p * np.log(p)).sum())
    for level in range(cached.shape[1] - 1):
        out[f"codebook_usage_{level}"] = len(np.unique(cached[:, level])) / model_cfg.codebook_size
    return out


def train(cfg: RqVaeTrainConfig, *, logger: Optional[MetricsLogger] = None, device=None):
    """Stage-1 training on ``device`` (cuda unless told otherwise; under
    ``torchrun``, this rank's GPU), over the (data, model) mesh of the
    process group ``torchrun`` describes; returns the trained params (the
    rank's shards under tensor parallelism)."""
    dev = resolve_device(device)
    mesh_lib.maybe_init_distributed(dev)
    logger = logger or MetricsLogger(every=cfg.log_every, sink=cfg.metrics_sink,
                                     tensorboard_dir=cfg.tensorboard_dir)
    model_cfg = cfg.model_config()
    compute_dtype = torch.bfloat16 if cfg.amp else torch.float32

    bundle = registry.load(
        cfg.dataset,
        cfg.data_path or cfg.dataset_folder,
        split=cfg.dataset_split if cfg.dataset == registry.RecDataset.AMAZON else None,
        need_seqs=False,
        synthetic_kwargs={"n_items": cfg.synthetic_n_items, "feature_dim": cfg.vae_input_dim,
                          "seed": cfg.seed},
    )
    items = bundle.items
    _slice = lambda x: dataset_lib.features_for_model(x, cfg.vae_input_dim)  # noqa: E731
    train_x = _slice(items.filtered("train" if cfg.do_eval else "all"))
    eval_x = _slice(items.filtered("eval")) if cfg.do_eval else None
    index_x = _slice(items.filtered("all"))

    mesh_lib.make_mesh(cfg.mesh_shape, cfg.tensor_parallel)
    rank = mesh_lib.rank()
    data_index = mesh_lib.data_index()
    local_bs = mesh_lib.process_local_batch_size(cfg.batch_size)
    params = rqvae_lib.init(torch.Generator().manual_seed(cfg.seed), model_cfg, device=dev)
    opt = optim.adamw(cfg.learning_rate, cfg.weight_decay)
    opt_state = opt.init(params)
    start_iter = 0

    resume_path = cfg.pretrained_rqvae_path
    if resume_path is None and cfg.auto_resume and ckpt_lib.latest_step(cfg.save_dir_root) is not None:
        resume_path = cfg.save_dir_root
    if resume_path is not None:
        state, meta = ckpt_lib.restore(resume_path, device=dev)
        params, opt_state = state["params"], state["opt_state"]
        start_iter = meta["step"] + 1
        print(f"---Loaded RQVAE Iter {meta['step']}---", file=sys.stderr)
    mesh_lib.broadcast_(tree_leaves(params))

    # a device generator for k-means and the Gumbel noise (this data
    # replica's, alike across a model group); the chunks' global batch
    # indices come from one seeded alike on every rank
    gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1 + data_index)
    index_gen = (torch.Generator(device=dev).manual_seed(cfg.seed + 1)
                 if mesh_lib.data_parallel() else None)
    if start_iter == 0 and cfg.use_kmeans_init:
        n_prime = min(cfg.kmeans_prime_items, train_x.shape[0])
        with dispatch.local_execution():   # on the whole parameters
            params = rqvae_lib.kmeans_prime(params, model_cfg,
                                            torch.from_numpy(train_x[:n_prime]).to(dev), gen,
                                            gumbel_t=cfg.gumbel_temperature)
        mesh_lib.broadcast_(tree_leaves(params))
    # the rank's shards of the whole tree (itself without tensor parallelism)
    state = mesh_lib.shard_state({"params": params, "opt_state": opt_state},
                                 mesh_lib.rqvae_tp_spec)
    params, opt_state = state["params"], state["opt_state"]
    del state

    accum = max(1, cfg.gradient_accumulate_every)
    step_fn = make_train_step(model_cfg, opt, accum, compute_dtype, debug_nans=cfg.debug_nans)
    eval_fn = make_eval_step(model_cfg, cfg.gumbel_temperature, compute_dtype)
    temp_sched = (
        temperature.TemperatureScheduler(t0=cfg.gumbel_temperature, min_t=cfg.gumbel_min_t,
                                         anneal_rate=cfg.gumbel_anneal_rate,
                                         step_size=cfg.gumbel_anneal_step_size)
        if cfg.gumbel_anneal
        else temperature.ConstantTemperature(cfg.gumbel_temperature)
    )

    # device-resident loop (steps_per_call > 1): chunks are clamped to the
    # next log / eval / save boundary, so the cadence is the host-fed loop's
    spc = max(1, cfg.steps_per_call)
    if spc > 1:
        corpus_dev = torch.from_numpy(train_x).to(dev)
        chunk_fns = {}

        def get_chunk_fn(n):
            if n not in chunk_fns:
                chunk_fns[n] = make_device_chunk(model_cfg, opt, accum, compute_dtype,
                                                 cfg.batch_size, n, debug_nans=cfg.debug_nans)
            return chunk_fns[n]

    # per-replica stream: each data replica samples its block of the global batch
    host_rng = np.random.default_rng(cfg.seed + data_index)
    profiler = StepProfiler(cfg.profile_dir, cfg.profile_start, cfg.profile_steps, device=dev)
    t_start = time.monotonic()
    examples_seen = 0
    first_it = start_iter
    it = start_iter - 1  # `it` = index of the last completed iteration
    while it + 1 < start_iter + cfg.iterations:
        it_start = it + 1
        profiler.step(it_start - start_iter)
        with profiling.span("train.step", step=it_start):
            gumbel_t = temp_sched.get_t(it_start)
            try:
                if spc > 1:
                    # the very first chunk is a single step, so the step-1 loss is
                    # logged as in the host-fed loop
                    cadences = (cfg.log_every, cfg.eval_every, cfg.save_model_every)
                    bounds = [c - it_start % c for c in cadences if c > 0]
                    if cfg.gumbel_anneal:
                        # t is read once per chunk: a chunk spans iters sharing get_t
                        bounds.append(temperature.constant_t_chunk_bound(
                            it_start, cfg.gumbel_anneal_step_size))
                    n = (min(spc, start_iter + cfg.iterations - it_start, *bounds)
                         if it_start != first_it else 1)
                    params, opt_state, metrics = get_chunk_fn(n)(params, opt_state, corpus_dev, gen,
                                                                 gumbel_t, index_gen)
                    it = it_start + n - 1
                else:
                    idx = host_rng.integers(0, train_x.shape[0], size=(accum, local_bs))
                    batch = torch.from_numpy(train_x[idx]).to(dev)
                    params, opt_state, metrics = step_fn(params, opt_state, batch, gen, gumbel_t)
                    it = it_start
            except FloatingPointError as e:
                raise FloatingPointError(f"step {it_start + 1}: {e}") from e
            examples_seen += (it - it_start + 1) * accum * cfg.batch_size

            if _every(it, cfg.log_every) or it_start == first_it:
                m = {k: v.cpu().numpy() for k, v in _replicated(metrics, "mean").items()}
                embs = m.pop("embs_norm_mean")
                m.update({f"emb_avg_norm_{i}": embs[i] for i in range(len(embs))})
                m["examples_per_s"] = examples_seen / (time.monotonic() - t_start)
                m["temperature"] = gumbel_t
                m["learning_rate"] = cfg.learning_rate
                logger.log(it + 1, m, force=True)

            last = it + 1 == start_iter + cfg.iterations
            if cfg.do_eval and eval_x.shape[0] and (_every(it, cfg.eval_every) or last):
                losses = []
                n_eval_rows = eval_x.shape[0]
                n_batches = min(cfg.eval_batches, max(1, n_eval_rows // cfg.batch_size))
                for eb in range(n_batches):
                    lo = eb * cfg.batch_size
                    # small eval sets wrap modulo the set: near-uniform repeats,
                    # one batch shape; each rank evaluates its block
                    rows = mesh_lib.host_block(np.arange(lo, lo + cfg.batch_size) % n_eval_rows,
                                               local_bs)
                    xe = torch.from_numpy(eval_x[rows]).to(dev)
                    losses.append(torch.stack([v.double() for v in eval_fn(params, xe)]))
                ev = mesh_lib.all_reduce_([torch.stack(losses)], "mean")[0].mean(dim=0).tolist()
                # corpus re-tokenization on rank 0 only, as the reference does,
                # on the whole parameters (the gather is a collective)
                whole = mesh_lib.gather_params(params, mesh_lib.rqvae_tp_spec)
                div = {}
                if rank == 0:
                    with dispatch.local_execution():
                        div = id_diversity_metrics(whole, model_cfg,
                                                   torch.from_numpy(index_x).to(dev))
                del whole
                logger.log(it + 1, {"eval_total_loss": ev[0], "eval_reconstruction_loss": ev[1],
                                    "eval_rqvae_loss": ev[2], **div}, force=True)

            if _every(it, cfg.save_model_every) or last:
                ckpt_lib.save(cfg.save_dir_root, it, {"params": params, "opt_state": opt_state},
                              meta={"config": config_lib.config_to_dict(cfg)},
                              spec_fn=mesh_lib.rqvae_tp_spec)
    profiler.close()
    return params


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    path = argv[0] if argv and "=" not in argv[0] else None
    overrides = argv[1:] if path else argv
    cfg = config_lib.load_config(RqVaeTrainConfig, path, overrides)
    train(cfg)


if __name__ == "__main__":
    main()
