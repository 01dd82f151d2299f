"""Runs one cell of ``BENCHMARK.json`` on the card(s) of this machine.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (from the process's start to the first timed step, ``setup_s``)
builds or finds the port's kernels, makes the cell's inputs and weights
from ``--seed`` and warms the cell's shapes; the window then runs the
cell's loop (``kinds/<kind>.py``, the kind named by the traffic mix) for
``--seconds``. With ``--trace 1`` a profiled slice follows the window and
the result carries the cell's per-layer metrics in place of its end-to-end
ones. After that the program's state is freed and the reference judges
what the timed path produced; ``correct`` is the verdict.

Earlier lines of standard output name the card and its power limit; the
last line is the result. The numbers compared, each with its limit, close
standard error and the result's line (``checks``). With no CUDA card, too
few cards, or a module of JAX or of the JAX package loaded, the run exits
with 1 and prints no result.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
from types import SimpleNamespace


def parse(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def context(args, bench: dict, device, clock) -> SimpleNamespace:
    from portbench import spec

    cell = spec.workload(bench, args.workload)
    return SimpleNamespace(name=cell["name"], cell=cell, seed=args.seed, seconds=args.seconds,
                           trace=bool(args.trace), config=spec.config(bench, cell["config"]),
                           traffic=spec.traffic(cell["traffic"]), device=device, clock=clock)


def on_card(cell: dict):
    """The card a run measures, after ``device.require``; its description."""
    import torch

    from portbench import device as device_lib

    device_lib.require(int(cell["chips"]))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    info = device_lib.describe(int(cell["chips"]))
    print(f"# device: {info['kind']}, count {torch.cuda.device_count()}; nvidia-smi name, "
          f"power.limit: {device_lib.power_limit()}", flush=True)
    build_s = device_lib.build_kernels()
    print(f"# kernels built or found in {build_s:.3f} s", flush=True)
    return dev, info


def main(argv=None, *, device=None, adjust=None) -> int:
    """Run the cell; ``device`` and ``adjust`` are for tests: a device that
    skips the look for a card (and the kernel build), and a function that
    edits the context (sizes) before the run."""
    from portbench import device as device_lib

    device_lib.settle()
    args = parse(argv)
    from portbench import judge, spec

    bench = spec.benchmark()
    cell = spec.workload(bench, args.workload)
    limits = spec.limits(cell["name"])
    if device is None:
        dev, info = on_card(cell)
    else:
        dev, info = device, {"platform": device.type, "kind": str(device), "count": 1}
    ctx = context(args, bench, dev, device_lib.process_seconds)
    if adjust is not None:
        adjust(ctx)
    for key, value in ctx.config.get("env", {}).items():
        os.environ[key] = str(value)
    kind = importlib.import_module(f"portbench.kinds.{ctx.traffic['kind']}")
    out = kind.run(ctx)
    bad = device_lib.forbidden_modules()
    if bad:
        print(f"portbench: the process loaded {bad}", file=sys.stderr)
        return 1
    correct, checks = judge.verdict(out["numbers"], limits)
    rec = out["record"]
    if args.trace:
        metrics = spec.read_per_layer(bench, cell["name"], rec)
    else:
        e2e = {m["name"]: m for m in spec.end_to_end(bench, cell["name"])}
        values = dict(rec["end_to_end"], setup_s=out["setup_s"])
        metrics = {n: {"value": values[n], "unit": m["unit"]} for n, m in e2e.items()}
    info["memory_peak_bytes"] = int(out["memory_peak_bytes"])
    print(f"# max_memory_allocated {info['memory_peak_bytes']} bytes, setup_s {out['setup_s']}",
          flush=True)
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics, "device": info}
    if args.trace:
        from portbench import trace

        tr = rec["trace"]
        info["busy_s"], info["window_s"] = tr["busy_s"], tr["window_s"]
        result["breakdown"] = trace.breakdown(tr["_trace"])
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
