"""Runs a slice of the timed path under ``torch.profiler`` and reduces its
trace: the device's kernels, copies and sets with their times, the busy
time (the union of their intervals), the slice's length by the host clock
(from its first step to the ``torch.cuda.synchronize()`` after its last),
and the longest idle gaps, each labelled by the CUDA runtime call the host
was in at the gap's middle (``host`` when it was in none: Python, numpy,
the batcher).

The profiler records the device only (CUPTI: kernels, copies, sets and the
runtime calls that launched them); recording every host operator as well
made a host-bound ML-32M step 1.6x slower, the device-only trace 1.13x.
One unrecorded step comes first: a session's first launches pay the
profiler's own start."""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from typing import Callable, List, NamedTuple, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace(NamedTuple):
    kernels: List[Tuple[str, float, float]]   # (name, start s, seconds), the slice's device ops
    busy_s: float
    window_s: float
    gaps: List[Tuple[str, float]]             # (what the host was in, seconds), longest first


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(events: list, window_s: float) -> Trace:
    """Reduce chrome-trace events (``ts`` / ``dur`` in microseconds) of one
    recorded slice whose host-clock length is ``window_s``."""
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    if not dev:
        raise RuntimeError("the trace holds no device operation")
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
                   if e.get("cat") == "cuda_runtime" and "dur" in e))
    starts = [h[0] for h in host]
    kernels = [(e["name"], float(e["ts"]) * 1e-6, float(e["dur"]) * 1e-6) for e in dev]
    busy = _merge([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev])
    busy_s = sum(b - a for a, b in busy) * 1e-6
    t0 = min(starts[:1] + [busy[0][0]])
    edges = [t0] + [x for iv in busy for x in iv]
    gaps = []
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid) - 1   # runtime calls of one thread do not overlap
        gaps.append((host[i][2] if i >= 0 and host[i][1] >= mid else "host", (b - a) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    return Trace(kernels, busy_s, window_s, gaps)


def profile(step: Callable[[], None], steps: int) -> Trace:
    """Run ``step`` (which enqueues device work) ``steps + 1`` times under
    the profiler, the first unrecorded; the recorded slice ends in
    ``torch.cuda.synchronize()``."""
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
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
            prof.step()
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return reduce(events, window_s)


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device ops that took most time (summed by name) and the longest
    idle gaps, each at most ``top`` entries."""
    by_name = {}
    for name, _, dur in tr.kernels:
        by_name[name] = by_name.get(name, 0.0) + dur
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in tr.gaps[:top]]}
