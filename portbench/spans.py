"""The port's program spans and counters (``rqvae_tpu_torch.utils.profiling``)
read on the card, beside the benchmark: one cell made as ``portbench.run``
makes it (``kinds/<kind>.prepare``), then

* windows of ``--steps`` steps or calls with recording off and on, in
  turns (off, on, on, off, ``--turns`` times): the rates, whose ratio is
  what recording costs;
* (a) from the windows with recording on, each step under a root
  ``train.step`` (each call under ``serve.call``) opened through the port's
  ``span()``: host self and total ms a step by span name, and the counters;
* (b) a profiled slice (the mix's ``trace_steps`` / ``trace_calls``) with
  recording on and a marker span around one ``torch.cuda.synchronize()``
  first. Each device op is put down to the innermost span open on the thread
  of the runtime call that launched it (matched by ``correlation``) at that
  call's time, failing that to the innermost span open on any thread then
  (so the backward's kernels, launched from the autograd engine's thread,
  fall under ``step.backward``). Each idle gap of the slice is put down to
  the innermost span open at its middle. A span's inclusive numbers count
  what falls in it or in any span inside it. The clock check: mapped onto
  the trace, the marker must enclose the trace's ``cudaDeviceSynchronize``
  within ``CLOCK_TOL_US``; if it does not, (b) gives no number and the
  skew is printed.

A serving call's wait for the card (``kinds.serve``'s ``_sync``, the
harness's and not the program's) runs under a span ``bench.wait`` of its
own, so the coverage tells the idle time in the harness's part of a call
from that in the program's spans and from what no span but the root holds.

    python3 -m portbench.spans --workload amazon_train --seed 7 [--steps 100] [--turns 2]

Earlier lines: ``# spans:`` (by name: host self ms, host total ms, device
ms, launches, a step), ``# idle by span:`` (idle ms a step, self and
inclusive), the clock check and the coverage; the last line is one JSON
object: the card, the rates, the values of ``METRICS`` (the per-layer
numbers these spans give, ``values``), the coverage and the clock check.
``portbench.run`` does not run this module: its cells' loops
(``kinds/*.py``) do not call ``window`` / ``profiled`` yet.
"""
from __future__ import annotations

import argparse
import heapq
import json
import os
import sys
import tempfile
import time
from typing import Callable, Optional

from portbench.trace import DEVICE_CATS, _merge
from rqvae_tpu_torch.utils import profiling

CLOCK_TOL_US = 20.0
MARKER = "clock.sync"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
STEP_SPANS = ("step.forward", "step.backward", "step.optimizer")
HARNESS_SPANS = ("bench.wait",)

# metric: (unit, the phase it reads, what it is)
METRICS = {
    "data_ms.train": ("ms", "a", "host self ms a step in data.* spans"),
    "padded_items.train": ("%", "a", "1 - data.valid_items / data.item_slots"),
    "enqueue_ms.train": ("ms", "a", "host ms a step in step.forward + step.backward + step.optimizer"),
    "optimizer_device_ms.train": ("ms", "b", "device ms a step launched under step.optimizer"),
    "attn_ms.train": ("ms", "b", "device ms a step under attn.fwd + attn.bwd"),
    "idle_enqueue_ms.train": ("ms", "b", "idle ms a step whose middle lies in a step.* span"),
    "enqueue_ms.serve": ("ms", "a", "host ms a call in search"),
    "decode_device_ms.serve": ("ms", "b", "device ms a call under search.level spans"),
    "attn_ms.serve": ("ms", "b", "device ms a call under attn.fwd"),
    "idle_enqueue_ms.serve": ("ms", "b", "idle ms a call whose middle lies in a search* span"),
}


# ---------------------------------------------------------------------------
# (a): host time by span
# ---------------------------------------------------------------------------


def host_summary(spans: list, root: str, steps: int) -> dict:
    """Host self and total ms a step by span name (``collect()``'s spans),
    the root's ms a step, the share of the root's time that the spans'
    self times add up to (every thread) and the share its named children
    cover."""
    child = {}
    for s in spans:
        if s[4]:
            child[s[4]] = child.get(s[4], 0) + (s[2] - s[1])
    by = {}
    for name, start, end, sid, *_ in spans:
        d = by.setdefault(name, {"self_ms": 0.0, "total_ms": 0.0, "count": 0})
        d["self_ms"] += (end - start - child.get(sid, 0)) * 1e-6 / steps
        d["total_ms"] += (end - start) * 1e-6 / steps
        d["count"] += 1
    out = {"steps": steps, "root": root, "by_name": by}
    r = by.get(root)
    if r and r["total_ms"] > 0:
        out["root_ms"] = r["total_ms"]
        out["self_sum_share"] = sum(d["self_ms"] for d in by.values()) / r["total_ms"]
        out["named_share"] = 1.0 - r["self_ms"] / r["total_ms"]
    return out


def window(step: Callable[[], None], steps: int, root: str, sync: Callable[[], None],
           on: bool) -> dict:
    """``steps`` steps back to back ending in ``sync()``, recording on or
    off; each step under a root span. Returns the seconds and, when on,
    what was recorded."""
    sync()
    if on:
        profiling.enable()
    t0 = time.perf_counter()
    for i in range(steps):
        with profiling.span(root, step=i):
            step()
    sync()
    seconds = time.perf_counter() - t0
    got = profiling.collect()
    profiling.disable()
    return {"seconds": seconds, "spans": got["spans"], "counters": got["counters"]}


# ---------------------------------------------------------------------------
# (b): device time and idle gaps by span
# ---------------------------------------------------------------------------


def _cover(intervals: list, times: list) -> list:
    """For each time, the indices of the intervals (a, b) with a <= t <= b."""
    order = sorted(range(len(intervals)), key=lambda i: intervals[i][0])
    ends, active, out, j = [], set(), [None] * len(times), 0
    for q in sorted(range(len(times)), key=times.__getitem__):
        t = times[q]
        while j < len(order) and intervals[order[j]][0] <= t:
            heapq.heappush(ends, (intervals[order[j]][1], order[j]))
            active.add(order[j])
            j += 1
        while ends and ends[0][0] < t:
            active.discard(heapq.heappop(ends)[1])
        out[q] = sorted(active)
    return out


def clock_check(marker: Optional[tuple], events: list, tol_us: float = CLOCK_TOL_US) -> dict:
    """Does the marker span (name, start us, end us, ...) enclose the
    trace's ``cudaDeviceSynchronize`` nearest to it within ``tol_us``?
    ``skew_us``: how far the event reaches out of the span (0 inside)."""
    syncs = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
             if e.get("cat") in LAUNCH_CATS and e.get("name") == "cudaDeviceSynchronize"
             and "dur" in e]
    if marker is None or not syncs:
        return {"ok": False, "skew_us": None, "why": "no marker span" if marker is None
                else "no cudaDeviceSynchronize in the trace"}
    a, b = marker[1], marker[2]
    e0, e1 = min(syncs, key=lambda e: abs(e[0] - a))
    skew = max(0.0, a - e0, e1 - b)
    return {"ok": skew <= tol_us, "skew_us": skew, "span_us": [a, b], "event_us": [e0, e1]}


def _tid(tid):
    try:
        return int(tid)
    except (TypeError, ValueError):
        return tid


def trace_tids(threads: Optional[dict]) -> dict:
    """{a trace's thread id: OS thread id} from ``collect()``'s threads
    ({OS thread id: ``threading.get_ident()``}). A CUDA-only trace names a
    runtime call's thread by its pthread id cut to 32 bits, as a signed
    number written without its sign (seen on the H100 machine); a trace with
    host operators may use the OS id."""
    out = {}
    for native, ident in (threads or {}).items():
        low = ident & 0xFFFFFFFF
        for key in (low, abs(low - (1 << 32) if low >= 1 << 31 else low), native):
            out[key] = native
    return out


def merge(events: list, base_ns: int, spans: list, steps: int, root: str,
          marker: str = MARKER, threads: Optional[dict] = None) -> dict:
    """Device ops and idle gaps of one profiled slice (chrome-trace events,
    ``ts`` / ``dur`` in us on the axis of ``baseTimeNanoseconds`` =
    ``base_ns``) put down to the slice's spans (``collect()``'s, Unix ns,
    and its ``threads``).
    Per step: ``device_ms`` / ``launches`` / ``idle_ms`` inclusive by name,
    ``device_self_ms`` / ``idle_self_ms`` by the innermost span, and the
    coverage: the shares of device and idle time whose innermost span is a
    named one (not the root), and of idle time in the program's own spans
    (not ``HARNESS_SPANS`` either); only ``clock`` when the clock check
    fails."""
    mapped = [(s[0], (s[1] - base_ns) / 1e3, (s[2] - base_ns) / 1e3) + tuple(s[3:])
              for s in spans]
    marks = [s for s in mapped if s[0] == marker]
    clock = clock_check(marks[0] if marks else None, events)
    out = {"steps": steps, "root": root, "clock": clock}
    if not clock["ok"]:
        return out
    sp = [s for s in mapped if s[0] != marker]
    intervals = [(s[1], s[2]) for s in sp]
    launch, tids = {}, trace_tids(threads)
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            tid = _tid(e.get("tid"))
            launch[e["args"]["correlation"]] = (float(e["ts"]), tids.get(tid, tid))
    ops = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    names = {s[0] for s in sp}
    zero = lambda: dict.fromkeys(names, 0.0)  # noqa: E731
    dev, dev_self, launches, idle, idle_self = zero(), zero(), zero(), zero(), zero()
    unplaced = {"device_ms": 0.0, "idle_ms": 0.0, "harness_idle_ms": 0.0}
    on_own_thread = 0

    def innermost(cover, tid=None):
        own = [i for i in cover if sp[i][6] == tid] if tid is not None else []
        pick = own or cover
        return (max(pick, key=lambda i: sp[i][1]) if pick else None), bool(own)

    found = [launch.get(e.get("args", {}).get("correlation")) for e in ops]
    covers = _cover(intervals, [f[0] if f else -1.0 for f in found])
    total_dev = 0.0
    for e, f, cover in zip(ops, found, covers):
        d = float(e["dur"]) * 1e-3
        total_dev += d
        i, own = innermost(cover, f[1]) if f else (None, False)
        on_own_thread += own
        if i is None or sp[i][0] == root:
            unplaced["device_ms"] += d
        if i is None:
            continue
        dev_self[sp[i][0]] += d
        for name in {sp[j][0] for j in cover}:
            dev[name] += d
            launches[name] += 1
    busy = _merge([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in ops])
    starts = sorted(float(e["ts"]) for e in events if e.get("cat") in LAUNCH_CATS and "dur" in e)
    edges = [min(starts[:1] + [busy[0][0]])] + [x for iv in busy for x in iv] if busy else []
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    total_idle = 0.0
    longest = []
    for (a, b), cover in zip(gaps, _cover(intervals, [0.5 * (a + b) for a, b in gaps])):
        d = (b - a) * 1e-3
        total_idle += d
        i, _ = innermost(cover)
        label = sp[i][0] if i is not None else "(none)"
        longest.append((d, label))
        if i is None or sp[i][0] == root:
            unplaced["idle_ms"] += d
        if i is None:
            continue
        if sp[i][0] in HARNESS_SPANS:
            unplaced["harness_idle_ms"] += d
        idle_self[sp[i][0]] += d
        for name in {sp[j][0] for j in cover}:
            idle[name] += d
    per = lambda d: {k: v / steps for k, v in d.items()}  # noqa: E731
    out.update(device_ms=per(dev), device_self_ms=per(dev_self), launches=per(launches),
               idle_ms=per(idle), idle_self_ms=per(idle_self),
               longest_gaps=[[label, d] for d, label in sorted(longest, reverse=True)[:10]],
               coverage={"device": 1.0 - unplaced["device_ms"] / total_dev if total_dev else None,
                         "idle": 1.0 - unplaced["idle_ms"] / total_idle if total_idle else None,
                         "idle_program": 1.0 - (unplaced["idle_ms"] + unplaced["harness_idle_ms"])
                         / total_idle if total_idle else None,
                         "launches_on_own_thread": on_own_thread / len(ops) if ops else None},
               device_ms_total=total_dev / steps, idle_ms_total=total_idle / steps)
    return out


def profiled(step: Callable[[], None], steps: int, root: str) -> dict:
    """(b) on the card: ``steps`` steps under the profiler (after one
    unrecorded, as ``trace.profile``) with recording on, the marker first."""
    import torch
    from torch.profiler import ProfilerActivity, schedule

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[ProfilerActivity.CUDA],
                                    schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                                    on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
            step()
            torch.cuda.synchronize()
            prof.step()
            profiling.enable()
            with profiling.span(MARKER):
                torch.cuda.synchronize()
            for i in range(steps):
                with profiling.span(root, step=i):
                    step()
            torch.cuda.synchronize()
            got = profiling.collect()
            profiling.disable()
            prof.step()
        with open(path) as f:
            trace = json.load(f)
    finally:
        profiling.disable()
        os.unlink(path)
    return merge(trace["traceEvents"], int(trace.get("baseTimeNanoseconds", 0)), got["spans"],
                 steps, root, threads=got.get("threads"))


# ---------------------------------------------------------------------------
# the values, and the lines
# ---------------------------------------------------------------------------


def _sum(d: Optional[dict], names) -> Optional[float]:
    if not d or not any(n in d for n in names):
        return None
    return sum(d.get(n, 0.0) for n in names)


def value(metric: str, record: dict) -> Optional[float]:
    """The value of one of ``METRICS`` from ``read``'s record (``{"a":
    host_summary plus "counters", "b": merge}``), or None where it finds
    nothing to read (no spans, the clock check failed)."""
    a, b = record.get("a") or {}, record.get("b") or {}
    if METRICS[metric][1] == "b" and not b.get("clock", {}).get("ok"):
        return None
    host = a.get("by_name")
    if metric == "data_ms.train":
        names = [n for n in host or () if n.startswith("data.")]
        return _sum({n: host[n]["self_ms"] for n in names}, names) if names else None
    if metric == "padded_items.train":
        c = a.get("counters") or {}
        return 100.0 * (1.0 - c["data.valid_items"] / c["data.item_slots"]) if c.get(
            "data.item_slots") else None
    if metric == "enqueue_ms.train":
        return _sum({n: d["total_ms"] for n, d in (host or {}).items()}, STEP_SPANS)
    if metric == "enqueue_ms.serve":
        return _sum({n: d["total_ms"] for n, d in (host or {}).items()}, ("search",))
    return _sum(*{
        "optimizer_device_ms.train": (b.get("device_ms"), ("step.optimizer",)),
        "attn_ms.train": (b.get("device_ms"), ("attn.fwd", "attn.bwd")),
        "idle_enqueue_ms.train": (b.get("idle_ms"), STEP_SPANS),
        "decode_device_ms.serve": (b.get("device_ms"), ("search.level",)),
        "attn_ms.serve": (b.get("device_ms"), ("attn.fwd",)),
        "idle_enqueue_ms.serve": (b.get("idle_ms"), ("search", "tokenize")),
    }[metric])


def lines(record: dict) -> list:
    """The ``# spans:`` and ``# idle by span:`` lines, and the checks'."""
    a, b = record.get("a") or {}, record.get("b") or {}
    host = a.get("by_name", {})
    out = ["# spans: " + json.dumps({n: [round(d["self_ms"], 4), round(d["total_ms"], 4),
                                         round(b.get("device_ms", {}).get(n, 0.0), 4),
                                         round(b.get("launches", {}).get(n, 0.0), 1)]
                                     for n, d in sorted(host.items(), key=lambda kv: -kv[1]["total_ms"])})
           + " (host self ms, host total ms, device ms, launches; a step)"]
    if "idle_ms" in b:
        out.append("# idle by span: " + json.dumps(
            {n: [round(b["idle_self_ms"][n], 4), round(v, 4)]
             for n, v in sorted(b["idle_ms"].items(), key=lambda kv: -kv[1]) if v > 0})
            + " (self, inclusive; idle ms a step)")
    c = b.get("clock", {})
    out.append(f"# spans clock: {'ok' if c.get('ok') else 'FAILED'}, skew {c.get('skew_us')} us "
               f"(marker {c.get('span_us')}, cudaDeviceSynchronize {c.get('event_us')}"
               f"{', ' + c['why'] if 'why' in c else ''})")
    if "coverage" in b or "root_ms" in a:
        out.append(f"# span coverage: device {b.get('coverage', {}).get('device')}, idle "
                   f"{b.get('coverage', {}).get('idle')} (the program's spans "
                   f"{b.get('coverage', {}).get('idle_program')}), launches on their own thread "
                   f"{b.get('coverage', {}).get('launches_on_own_thread')}; host: root "
                   f"{a.get('root_ms')} ms a step, self times sum to {a.get('self_sum_share')} of "
                   f"it, named children cover {a.get('named_share')}")
    return out


# ---------------------------------------------------------------------------
# on the card, one cell
# ---------------------------------------------------------------------------


def _cell(ctx):
    """(step, root, units a step) of the cell's loop: ``kinds/<kind>``'s
    own step, made by its own ``prepare``."""
    import importlib

    kind = importlib.import_module(f"portbench.kinds.{ctx.traffic['kind']}")
    cell = kind.prepare(ctx)
    if ctx.traffic["kind"] == "train":
        return cell.one_step, "train.step", cell.bs, int(ctx.traffic.get("trace_steps", 10))

    def call():
        cell.one_call(cell.calls)
        cell.calls += 1

    sync = kind._sync

    def wait(dev):
        with profiling.span("bench.wait"):
            sync(dev)

    kind._sync = wait   # the call's wait for the card, looked up when a call runs

    return call, "serve.call", cell.bs, int(ctx.traffic.get("trace_calls", 10))


def main(argv=None) -> int:
    from portbench import device as device_lib

    device_lib.settle()
    p = argparse.ArgumentParser(prog="python3 -m portbench.spans")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--turns", type=int, default=2)
    args = p.parse_args(argv)
    import torch

    from portbench import run, spec

    bench = spec.benchmark()
    cell = spec.workload(bench, args.workload)
    dev, info = run.on_card(cell)
    ns = argparse.Namespace(workload=args.workload, seed=args.seed, seconds=0.0, trace=1)
    ctx = run.context(ns, bench, dev, device_lib.process_seconds)
    for key, val in ctx.config.get("env", {}).items():
        os.environ[key] = str(val)
    step, root, units, traced_steps = _cell(ctx)
    sync = torch.cuda.synchronize
    rates = {"off": [], "on": []}
    recorded, counters = [], {}
    for on in (False, True, True, False) * args.turns:
        w = window(step, args.steps, root, sync, on)
        rates["on" if on else "off"].append(args.steps * units / w["seconds"])
        recorded += w["spans"]
        for k, v in w["counters"].items():
            counters[k] = counters.get(k, 0) + v
    a = dict(host_summary(recorded, root, len(rates["on"]) * args.steps), counters=counters)
    record = {"a": a, "b": profiled(step, traced_steps, root)}
    for line in lines(record):
        print(line, flush=True)
    cost = 1.0 - sum(rates["on"]) / sum(rates["off"])
    print(f"# rates ({units} a step): off {rates['off']}, on {rates['on']}: recording costs "
          f"{100 * cost:.2f} %", flush=True)
    kind = "train" if root == "train.step" else "serve"
    values = {m: value(m, record) for m in METRICS if m.endswith("." + kind)}
    print(json.dumps({"workload": args.workload, "seed": args.seed, "device": info,
                      "power_limit": device_lib.power_limit(), "rates": rates,
                      "on_cost": cost, "values": values, "clock": record["b"]["clock"],
                      "coverage": record["b"].get("coverage"),
                      "host": {k: a.get(k) for k in ("root_ms", "self_sum_share", "named_share")},
                      "longest_gaps": record["b"].get("longest_gaps")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
