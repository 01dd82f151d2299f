"""Decoder training in a closed loop on one card: steps back to back, each
the body of ``train_decoder.train``'s loop as the port runs it (host
``sample_batch``, ``bucket_slices``, ``make_seq_batch``, ``to_device``, then
one ``grad_accum_fn`` a bucket and ``apply_fn``; or, with one bucket, the
flat ``make_train_step``).

Set-up makes the corpus table, the histories and the weights from the
seed, builds the step once and drives it through its first steps, which
the reference follows (``judge``): the window then runs that same object.
The window's rate is every example of the steps it ran over its seconds,
which end in ``torch.cuda.synchronize()``.
"""
from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import counts, judge, reference, traffic
from portbench.reference import model as ref_model
from portbench.reference import train as ref_train

CHECK_STEPS = 3


def seeds(seed: int, n: int = 4):
    return [int(x) for x in np.random.SeedSequence(seed).generate_state(n, dtype=np.uint64) >> 1]


def prepare(ctx) -> SimpleNamespace:
    """The cell's state after set-up: the port's step built and driven
    through ``CHECK_STEPS`` steps (their batches, dropout states, losses,
    first moments and parameters kept for the check) and the mix's
    warm-up steps."""
    from rqvae_tpu_torch.data import dataset as dataset_lib
    from rqvae_tpu_torch.data.schemas import SeqBatch
    from rqvae_tpu_torch.tokenizer import semids
    from rqvae_tpu_torch.train import optim
    from rqvae_tpu_torch.train import train_decoder as td
    from rqvae_tpu_torch.utils import config as config_lib
    from rqvae_tpu_torch.utils.tree import tree_leaves, tree_map

    cfg, mix, dev = ctx.config, ctx.traffic, ctx.device
    s_data, s_weights, s_host, s_drop = seeds(ctx.seed)
    dcfg = config_lib.from_dict(td.DecoderTrainConfig, cfg["decoder"])
    max_len = int(cfg["max_seq_len"])
    model_cfg = dcfg.retrieval_config(max_len)
    sem_dim = model_cfg.sem_id_dim
    rng = np.random.default_rng(s_data)
    codes = traffic.corpus_tuples(rng, int(cfg["n_items"]), sem_dim - 1, dcfg.vae_codebook_size)
    cached = np.concatenate([codes, traffic.dedup_column(codes)[:, None]], axis=1).astype(np.int32)
    index = semids.build_index(torch.from_numpy(cached).to(dev), dcfg.vae_codebook_size)
    ids, fut, owner = traffic.histories(rng, mix, int(cfg["n_items"]))
    seqs = dataset_lib.SeqDataset(user_ids=owner, item_ids=ids, item_ids_fut=fut,
                                  max_seq_len=max_len)
    shape = ref_model.decoder_shape(cfg["decoder"], max_len)
    params = ref_model.init_decoder(torch.Generator(device=dev).manual_seed(s_weights), shape, dev)
    opt = optim.adamw(optim.inv_sqrt_schedule(dcfg.learning_rate, dcfg.warmup_steps),
                      dcfg.weight_decay)
    compute_dtype = torch.bfloat16 if dcfg.amp else torch.float32
    bs = int(mix["batch"])
    n_buckets = dcfg.length_buckets if dcfg.length_buckets > 1 and bs % dcfg.length_buckets == 0 else 1
    if n_buckets > 1:
        grad_accum_fn, apply_fn = td.make_bucketed_fns(model_cfg, opt, index, compute_dtype, sem_dim)
    else:
        step_fn = td.make_train_step(model_cfg, opt, index, 1, compute_dtype, sem_dim)
    seq_batch = lambda raw: dataset_lib.make_seq_batch(raw, None, with_features=False)  # noqa: E731
    host_rng = np.random.default_rng(s_host)
    gen = torch.Generator(device=dev).manual_seed(s_drop)
    state = {"params": params, "opt": opt.init(params)}

    def one_step():
        """One loop body; returns (raw batch, loss tensor, host seconds,
        [(items a row, padded items)] a bucket)."""
        t0 = time.perf_counter()
        raw = seqs.sample_batch(host_rng, bs, subsample=True)
        lengths = (raw["ids"] >= 0).sum(axis=1)
        host = time.perf_counter() - t0
        p, o = state["params"], state["opt"]
        if n_buckets > 1:
            t0 = time.perf_counter()
            groups = td.bucket_slices(lengths, n_buckets)
            host += time.perf_counter() - t0
            grads = tree_map(torch.zeros_like, p)
            loss = torch.zeros((), device=dev)
            loss_d = torch.zeros((sem_dim,), device=dev)
            for rows, length in groups:
                t0 = time.perf_counter()
                sub = seq_batch({"user_ids": raw["user_ids"][rows], "ids": raw["ids"][rows, :length],
                                 "ids_fut": raw["ids_fut"][rows]})
                host += time.perf_counter() - t0
                grads, loss, loss_d = grad_accum_fn(p, grads, loss, loss_d,
                                                    dataset_lib.to_device(sub, dev), gen, 1.0 / n_buckets)
            p, o = apply_fn(p, o, grads, loss)
            shapes = [(lengths[rows], length) for rows, length in groups]
        else:
            t0 = time.perf_counter()
            one = seq_batch(raw)
            stacked = SeqBatch(*(np.stack([x]) for x in one))
            host += time.perf_counter() - t0
            p, o, metrics = step_fn(p, o, dataset_lib.to_device(stacked, dev), gen)
            loss = metrics["total_loss"]
            shapes = [(lengths, raw["ids"].shape[1])]
        state["params"], state["opt"] = p, o
        return raw, loss, host, shapes

    kept = SimpleNamespace(raws=[], gen_states=[], losses=[])
    for i in range(CHECK_STEPS):
        kept.gen_states.append(gen.get_state().clone())
        raw, loss, _, _ = one_step()
        kept.raws.append(raw)
        kept.losses.append(float(loss))
        if i == 0:
            kept.grad1 = [m.detach().clone() / (1.0 - opt.b1) for m in tree_leaves(state["opt"].mu)]
    kept.params3 = [x.detach().clone() for x in tree_leaves(state["params"])]
    for _ in range(int(mix.get("warmup_steps", 2))):
        one_step()
    torch.cuda.synchronize() if dev.type == "cuda" else None
    return SimpleNamespace(ctx=ctx, one_step=one_step, state=state, kept=kept, cached=cached,
                           shape=shape, bs=bs, n_buckets=n_buckets, dcfg=dcfg,
                           seeds=(s_data, s_weights, s_host, s_drop),
                           count_shape=counts.shape_of(shape),
                           dtype="bfloat16" if dcfg.amp else "float32")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def window(cell, seconds: float) -> dict:
    """Steps back to back for ``seconds``; the record's ``window`` and
    ``counters``."""
    dev = cell.ctx.device
    s = cell.shape
    steps, host_s, slots, valid, items, gaps = 0, 0.0, 0, 0, [], []
    _sync(dev)
    t0 = time.perf_counter()
    while True:
        before = time.perf_counter()
        _, _, host, shapes = cell.one_step()
        gaps.append(time.perf_counter() - before)
        steps += 1
        host_s += host
        for lengths, pad in shapes:
            slots += len(lengths) * (int(pad) * s.sem_dim + 1)
            valid += int(np.sum(lengths)) * s.sem_dim + len(lengths)
            items.append(np.asarray(lengths))
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            break
    _sync(dev)
    elapsed = time.perf_counter() - t0
    print(f"# window: {steps} steps, host ms a step p50 {1e3 * np.median(gaps):.3f}, max "
          f"{1e3 * max(gaps):.3f} at {sum(gaps[:int(np.argmax(gaps))]):.3f} s", flush=True)
    flops = counts.train_flops(cell.count_shape, np.concatenate(items))
    return {"window": {"seconds": elapsed, "steps": steps, "examples": steps * cell.bs,
                       "flops": flops, "peak_flops": counts.PEAK_FLOPS[cell.dtype]},
            "counters": {"steps": steps, "host_batch_s": host_s, "slots": slots,
                         "valid_slots": valid}}


def traced(cell, steps: int) -> dict:
    """``steps`` steps under the profiler (after one unrecorded); the
    trace's reduction and the bound of the recorded steps' attention calls."""
    from portbench import trace

    bound = []

    def body():
        _, _, _, shapes = cell.one_step()
        bound.append(sum(counts.bound_s(call, "fwd", cell.dtype) + counts.bound_s(call, "bwd", cell.dtype)
                         for call in counts.train_attention_calls(cell.count_shape, shapes)))

    tr = trace.profile(body, steps)
    return {"kernels": tr.kernels, "busy_s": tr.busy_s, "window_s": tr.window_s,
            "gaps": tr.gaps, "attn_bound_s": sum(bound[1:]), "steps": steps, "_trace": tr}


def program_outputs(cell) -> dict:
    k = cell.kept
    return {"losses": k.losses, "grad1": k.grad1, "params3": k.params3}


def reference_outputs(cell, tf32: bool = False) -> dict:
    """The reference's first ``CHECK_STEPS`` steps from the same weights,
    batches and dropout states (``tf32``: in TF32, the control)."""
    dev = cell.ctx.device
    s = cell.shape
    params = ref_model.init_decoder(torch.Generator(device=dev).manual_seed(cell.seeds[1]), s, dev)
    flat = ref_train.leaves(params)
    moments = ([torch.zeros_like(x) for x in flat], [torch.zeros_like(x) for x in flat])
    opt = ref_train.optimizer(cell.ctx.config["decoder"])
    cached = torch.from_numpy(cell.cached).to(dev).long()
    losses, grad1, start = [], None, [x.clone() for x in flat]
    with reference.precision(tf32):
        for i in range(CHECK_STEPS):
            g = torch.Generator(device=dev)
            g.set_state(cell.kept.gen_states[i])
            loss, grads = ref_train.gradients(params, s, cached, cell.kept.raws[i], cell.n_buckets, g)
            params, moments = ref_train.adamw(params, moments, i, opt, grads)
            losses.append(loss)
            if i == 0:
                grad1 = grads
    return {"losses": losses, "grad1": grad1, "params3": ref_train.leaves(params), "start": start}


def numbers(program: dict, ref: dict) -> dict:
    keep = judge.moving_leaves(ref["grad1"])
    change = lambda out: [p - s for p, s in zip(out["params3"], ref["start"])]  # noqa: E731
    return {"loss_gap": judge.loss_gap(program["losses"], ref["losses"]),
            "grad_gap": judge.leaf_gap(program["grad1"], ref["grad1"]),
            "update_gap": judge.leaf_gap(change(program), change(ref), keep)}


def run(ctx) -> dict:
    """The whole run: set-up, window, the traced slice (``ctx.trace``),
    the peak memory, then the check against the reference."""
    cell = prepare(ctx)
    setup_s = ctx.clock()
    rec = window(cell, ctx.seconds)
    rec["end_to_end"] = {"train_examples_per_s": rec["window"]["examples"] / rec["window"]["seconds"]}
    if ctx.trace:
        rec["trace"] = traced(cell, int(ctx.traffic.get("trace_steps", 3)))
    peak = torch.cuda.max_memory_allocated() if ctx.device.type == "cuda" else 0
    program = program_outputs(cell)
    attempted = rec["window"]["steps"]
    del cell.state["params"], cell.state["opt"]
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_outputs(cell)
    return {"setup_s": setup_s, "record": rec, "numbers": numbers(program, ref),
            "attempted": attempted, "failed": 0, "memory_peak_bytes": peak}
