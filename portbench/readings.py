"""The readings that the limits of ``limits/<cell>.json`` are set from, on
the card at the cell's own sizes, in one process:

* the program on ``--seeds`` seeds (sound runs: the lower reading is the
  largest);
* the control on ``--controls`` seeds: the reference in the program's
  place, computed in the precision below the configuration's (TF32 for
  float32 with TF32 off);
* the faults on ``--faults`` seeds, each planted in the program: for a
  training cell half of the batch left out (the loss meaned over the
  rest), for a serving cell the last token of every answer altered where
  it is produced. (A training step that leaves its state unchanged reads 1
  on ``update_gap`` by construction and needs no run.)

    python3 -m portbench.readings --workload amazon_train --seeds 12 --controls 3 --faults 3

One JSON line a reading, then a summary. The benchmark's own runs never
run this.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import torch


@contextlib.contextmanager
def fault(kind: str, name: str):
    """Plant the named fault in the port for the block."""
    if name == "half_batch":
        from rqvae_tpu_torch.data.schemas import TokenizedSeqBatch
        from rqvae_tpu_torch.models import retrieval

        orig = retrieval.forward

        def half(params, cfg, batch, **kw):
            n = batch.sem_ids.shape[0] // 2
            return orig(params, cfg, TokenizedSeqBatch(*(None if x is None else x[:n] for x in batch)),
                        **kw)

        retrieval.forward = half
        try:
            yield
        finally:
            retrieval.forward = orig
    elif name == "unchanged_state":
        from rqvae_tpu_torch.train import optim

        orig = optim.AdamW.update
        optim.AdamW.update = lambda self, params, state, grads: state
        try:
            yield
        finally:
            optim.AdamW.update = orig
    elif name == "altered_token":
        from rqvae_tpu_torch.models import generation

        orig = generation.generate_next_sem_ids

        def altered(*args, **kw):
            out = orig(*args, **kw)
            sem = out.sem_ids.clone()
            sem[..., -1] = (sem[..., -1] + 1) % args[1].num_embeddings
            return generation.GenerationOutput(sem, out.log_probas)

        generation.generate_next_sem_ids = altered
        try:
            yield
        finally:
            generation.generate_next_sem_ids = orig
    else:
        raise ValueError(f"unknown fault {name!r}")


FAULTS = {"train": ("half_batch",), "serve": ("altered_token",)}


def train_reading(ctx, role: str) -> dict:
    from portbench.kinds import train as kt

    cell = kt.prepare(ctx)
    ref = kt.reference_outputs(cell)
    program = kt.reference_outputs(cell, tf32=True) if role == "control" else kt.program_outputs(cell)
    del cell.state["params"], cell.state["opt"]
    return kt.numbers(program, ref)


def serve_reading(ctx, role: str) -> dict:
    from portbench.kinds import serve as ks

    cell = ks.prepare(ctx)
    calls = [(cell.rows_of(j), *cell.one_call(j)[1]) for j in range(int(ctx.traffic.get("check_calls", 4)))]
    if role == "control":
        tuples_c, _ = ks.reference_corpus(cell, None, tf32=True)
        tuples, bad = ks.reference_corpus(cell, tuples_c)
        answers = []
        for rows, _, _ in calls:
            (beams, scores), _ = ks.reference_search(cell, tuples_c, rows, tf32=True)
            answers.append((rows, beams, scores))
    else:
        tuples, bad = ks.reference_corpus(cell, cell.index.cached_ids)
        answers = calls
    return ks.judge_calls(cell, tuples, bad, answers)


def main(argv=None) -> int:
    from portbench import device as device_lib
    from portbench import run, spec

    p = argparse.ArgumentParser(prog="python3 -m portbench.readings")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--base-seed", type=int, default=2**31 + 1000)
    args = p.parse_args(argv)
    device_lib.settle()
    bench = spec.benchmark()
    cell = spec.workload(bench, args.workload)
    dev, _ = run.on_card(cell)
    kind = spec.traffic(cell["traffic"])["kind"]
    reading = {"train": train_reading, "serve": serve_reading}[kind]
    plan = ([("program", None)] * args.seeds + [("control", None)] * args.controls
            + [("fault", f) for f in FAULTS[kind] for _ in range(args.faults)])
    out = {}
    for i, (role, name) in enumerate(plan):
        seed = args.base_seed + 7919 * i
        ns = argparse.Namespace(workload=args.workload, seed=seed, seconds=1.0, trace=0)
        ctx = run.context(ns, bench, dev, device_lib.process_seconds)
        for key, value in ctx.config.get("env", {}).items():
            os.environ[key] = str(value)
        ctx.traffic["warmup_steps"] = 0
        ctx.traffic["warmup_calls"] = 0
        t0 = time.perf_counter()
        with fault(kind, name) if name else contextlib.nullcontext():
            nums = reading(ctx, role)
        torch.cuda.empty_cache()
        tag = role if name is None else name
        print(json.dumps({"role": tag, "seed": seed, "seconds": time.perf_counter() - t0, **nums}),
              flush=True)
        for k, v in nums.items():
            out.setdefault(tag, {}).setdefault(k, []).append(v)
    summary = {tag: {k: {"max": max(v), "min": min(v)} for k, v in d.items()} for tag, d in out.items()}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
