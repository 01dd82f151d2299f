"""The readings that ``limits/dsv2lite_serve.json`` is set from, on the card
at the cell's own sizes, in one process (``readings.py``'s plan for the
decoder-only retriever, ``kinds/serve_lm.py``):

* the program on ``--seeds`` seeds (``route_mismatch`` counts the router's
  near-ties that bf16 resolves otherwise than the float32 reference);
* the control on ``--controls`` seeds: the reference in the program's
  place on the weights round-tripped through ``float8_e4m3fn`` with a
  per-tensor scale (the precision below the configuration's bf16), its
  own search giving the beams, its rescoring the logits and its forward
  the routes;
* the faults on ``--faults`` seeds each, planted in the port: the decode
  steps' RoPE positions one too far (``rope_off_by_one``), top-5 routing
  in place of top-6 (``top5``), the history cache's padding slots attended
  (``pad_attended``), each expert's row range of the grouped products
  shifted by one expert (``dispatch_shift``);
* the host synchronisations of one search (``torch.cuda.set_sync_debug_mode``),
  by the line that made them, on the first program seed.

    python3 -m portbench.readings_lm --seeds 6 --controls 3 --faults 3

One JSON line a reading, then a summary. The benchmark's own runs never
run this.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time

import torch

WORKLOAD = "dsv2lite_serve"
FAULTS = ("rope_off_by_one", "top5", "pad_attended", "dispatch_shift")


@contextlib.contextmanager
def fault(name: str):
    """Plant the named fault in the port for the block."""
    from rqvae_tpu_torch.models import mla, moe, retrieval_lm

    if name == "rope_off_by_one":
        mod, attr = retrieval_lm, "decode_positions"
        orig = mod.decode_positions
        planted = lambda hist, level, beams: orig(hist, level, beams) + 1  # noqa: E731
    elif name == "top5":
        mod, attr = moe, "route"
        orig = mod.route
        planted = lambda p, cfg, x: orig(p, dataclasses.replace(cfg, top_k=cfg.top_k - 1), x)  # noqa: E731
    elif name == "pad_attended":
        mod, attr = mla, "decode"
        orig = mod.decode

        def planted(p, cfg, x, cos, sin, hist, hist_valid, own):
            return orig(p, cfg, x, cos, sin, hist, torch.ones_like(hist_valid), own)
    elif name == "dispatch_shift":
        mod, attr = moe, "_experts"
        orig = mod._experts
        planted = lambda p, x, w, order, ends: orig(  # noqa: E731
            p, x, w, order, torch.cat([ends[1:], ends[-1:]]))
    else:
        raise ValueError(f"unknown fault {name!r}")
    setattr(mod, attr, planted)
    try:
        yield
    finally:
        setattr(mod, attr, orig)


def fp8_round_trip(tree):
    """Each tensor through ``float8_e4m3fn`` with a per-tensor scale (its
    largest magnitude to 448), back as float32."""
    if isinstance(tree, dict):
        return {k: fp8_round_trip(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [fp8_round_trip(v) for v in tree]
    t = tree.float()
    scale = float(t.abs().max()) / 448.0 or 1.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def host_syncs(cell) -> dict:
    """The synchronising CUDA calls of one search on a call's batch (as
    ``torch.cuda.set_sync_debug_mode`` warns of them), by the innermost
    line of this repository on the stack, then the innermost line."""
    import collections
    import os
    import traceback
    import warnings

    sites = collections.Counter()

    def seen(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" in str(message):
            stack = traceback.extract_stack()[:-1]
            ours = [f for f in stack if os.path.abspath(f.filename).startswith(os.getcwd())]
            where = (f"{os.path.relpath(ours[-1].filename)}:{ours[-1].lineno}" if ours else "?")
            sites[f"{where} ({os.path.basename(filename)}:{lineno})"] += 1

    tok = cell.batch_of(cell.rows_of(0))
    cell.search(tok)            # the first search's one-time set-up aside
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        warnings.showwarning = seen       # after the switch, which warns of itself
        try:
            cell.search(tok)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return {"role": "host_syncs", "search": sum(sites.values()), "sites": dict(sites)}


def reading(ctx, role: str, probe=None) -> dict:
    from portbench.kinds import serve, serve_lm
    from portbench.reference import lm as ref_lm

    cell = serve_lm.prepare(ctx)
    if probe is not None:
        probe(cell)
    mix = ctx.traffic
    calls = [(cell.rows_of(j), *cell.one_call(j)[1]) for j in range(int(mix.get("check_calls", 4)))]
    calls.sort(key=lambda c: -int(cell.lengths[c[0]].max()))
    picked = serve_lm.pick_users(cell, calls, int(mix.get("check_users", 32)))
    tuples, bad = serve.reference_corpus(cell, cell.index.cached_ids)
    ref_params = ref_lm.as_float(cell.params)
    if role == "control":
        ctrl = fp8_round_trip(cell.params)
        rows = [r for r, _, _ in serve_lm.served(calls, picked)]
        users = cell.owner[rows].tolist()
        hists = [ref_lm.history_tokens(tuples, cell.ids[r][cell.ids[r] >= 0]) for r in rows]
        pre = serve.ref_corpus.Prefixes(tuples, cell.shape.codebook)
        with torch.no_grad():
            beams, scores = ref_lm.beam_search(ctrl, cell.shape, users, hists, pre, cell.k)
            _, logits = ref_lm.rescore(ctrl, cell.shape, users, hists, pre, beams)
        routes = serve_lm.reference_routes(ctrl, cell.shape, users, hists)
        del ctrl
        judged = [(r, beams[i], scores[i]) for i, r in enumerate(rows)]
    else:
        logits, routes = serve_lm.program_outputs(cell, calls, picked)
        judged = serve_lm.served(calls, picked)
    return serve_lm.judge(cell, tuples, bad, judged, logits, routes, ref_params)


def main(argv=None) -> int:
    from portbench import device as device_lib
    from portbench import run, spec

    p = argparse.ArgumentParser(prog="python3 -m portbench.readings_lm")
    p.add_argument("--seeds", type=int, default=6)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--base-seed", type=int, default=2**31 + 2000)
    args = p.parse_args(argv)
    device_lib.settle()
    bench = spec.benchmark()
    cell = spec.workload(bench, WORKLOAD)
    dev, _ = run.on_card(cell)
    plan = ([("program", None)] * args.seeds + [("control", None)] * args.controls
            + [("fault", f) for f in FAULTS for _ in range(args.faults)])
    out = {}
    for i, (role, name) in enumerate(plan):
        seed = args.base_seed + 7919 * i
        ns = argparse.Namespace(workload=WORKLOAD, seed=seed, seconds=1.0, trace=0)
        ctx = run.context(ns, bench, dev, device_lib.process_seconds)
        ctx.traffic["warmup_calls"] = 0
        t0 = time.perf_counter()
        probe = (lambda cell: print(json.dumps(host_syncs(cell)), flush=True)) if i == 0 else None
        with fault(name) if name else contextlib.nullcontext():
            nums = reading(ctx, role, probe)
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
