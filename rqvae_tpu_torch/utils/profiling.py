"""Program spans and counters, and step-windowed trace capture on
``torch.profiler`` behind the train loops' ``profile_dir`` /
``profile_start`` / ``profile_steps`` fields (``StepProfiler``, counterpart
of rqvae_tpu/utils/profiling.py, the same constructor and behaviour).

Spans and counters
------------------
``span(name, **args)`` is a context manager that records one host interval
of the program under a name of the fixed vocabulary below; ``count(name,
n)`` adds ``n`` to a counter. Both record only between ``enable()`` and
``disable()``; ``collect()`` returns what was recorded and clears it.
Recording is off by default, and then ``span`` returns one shared no-op
object and ``count`` returns at once. A site whose arguments cost work
(shapes, a mask's sum) computes them only under ``if enabled():``.

Spans are kept in memory as flat tuples (``SPAN_FIELDS``) and written out
only when collected: name, start and end in Unix nanoseconds, the span's
id, its parent's id (0 for a root), the id of its thread's root span (the
request it belongs to), the OS thread id (``threading.get_native_id()``)
and its args. Each thread has its own stack of open spans: the autograd
engine runs a CUDA backward on a thread of its own, so ``attn.bwd`` spans
are roots there. Times are stamped with ``time.perf_counter_ns()`` and
mapped to Unix time through anchor pairs (``perf_counter_ns``,
``time_ns``) taken at ``enable()`` and at each ``collect()``, the clock a
``torch.profiler`` chrome trace is on: its ``ts`` (microseconds) is Unix
nanoseconds less the trace's ``baseTimeNanoseconds``, over 1000
(``add_spans_to_chrome_trace``).

The vocabulary, by layer:

* host data: ``data.sample`` (``SeqDataset.sample_batch`` / ``batch_at``),
  ``data.bucket`` (``bucket_slices``), ``data.batch`` (``make_seq_batch``;
  counters ``data.item_slots``, the batch's item slots, and
  ``data.valid_items``, its valid ones), ``data.to_device``;
* train step: ``train.step`` (a root a loop iteration of ``train()``, arg
  ``step``), ``step.forward`` (the loss inside ``value_and_grad``),
  ``step.backward`` (``torch.autograd.grad``), ``step.optimizer`` (the
  gradients' reduction and the AdamW update);
* collectives: ``comm.all_reduce`` (``mesh.all_reduce_`` when a data mesh
  acts; counter ``comm.all_reduce_bytes``);
* tokenizer: ``tokenize`` (``tokenize_sequences``, the cached-ID gather
  that the training loss and the search's callers both run);
* beam search: ``search`` (``generate_next_sem_ids``),
  ``search.encode`` (the encoder and its cached cross K / V),
  ``search.level`` (arg ``level``: one decoded token, 0 the BOS step: the
  cached decode, log-softmax, mask, top-k and the KV reorder),
  ``search.children_mask`` (inside its level); for the decoder-only model
  ``search.prefill`` (the histories' prefill, before level 0, in place of
  ``search.encode``);
* model layers of the decoder-only model (``models/mla``, ``models/moe``):
  ``mla.prefill`` and ``mla.decode`` (a layer's latent attention, its
  projections included, at prefill and at a decode step; counter
  ``mla.cache_tokens``, the latent-cache tokens the decode steps attend,
  the history's once a user and each beam row's own, summed over layers),
  ``moe.route`` (router, top-k and the pairs' sort by expert with each
  expert's row range, on the device), ``moe.experts`` (the routed pairs' expert
  products and their weighted sum), ``moe.shared`` and ``mlp.dense``
  (counters ``moe.pairs``, the routed (token, expert) pairs,
  ``moe.expert_pairs_max``, the busiest expert's pairs, and
  ``moe.experts_touched``, the experts given any pair, each summed over
  layer calls);
* kernels: ``attn.fwd`` (``ops/attention.attend``) and ``attn.bwd`` (the
  backward of the flash autograd functions), args ``family`` (``flat``,
  ``small``, ``spans``, ``sdpa``), ``B``, ``H``, ``Nq``, ``Nk``, ``Dh``,
  ``dtype``, ``causal``.

Trace capture
-------------
The trace records the host's operators, and the device's kernels and copies
when the loop runs on CUDA. It is written as a Chrome trace JSON file
(``<host>_<pid>.<time>.pt.trace.json``, the name
``torch.profiler.tensorboard_trace_handler`` gives, one a rank under data
parallelism; no ``tensorboard`` package needed to write it), which
TensorBoard's profiler plugin, Perfetto or ``chrome://tracing`` reads.
Span recording is on while the window is open, and the window's spans are
written into the trace as ``X`` events of ``cat`` ``program_span`` on
their threads, on the trace's clock, so a viewer shows them above the
operators and kernels; the window's counters are written as ``C`` events
(the window's totals, at its end), so a viewer shows each as a track.

Before the trace stops, the device is synchronised, so every kernel the
window enqueued has finished and is in the trace: that costs one host sync
at the window's end, and nothing on steps outside the window.
"""
from __future__ import annotations

import itertools
import json
import os
import socket
import threading
import time
from typing import Optional

import torch

SPAN_FIELDS = ("name", "start_ns", "end_ns", "id", "parent", "request", "tid", "args")
VOCABULARY = ("data.sample", "data.bucket", "data.batch", "data.to_device", "train.step",
              "step.forward", "step.backward", "step.optimizer", "comm.all_reduce",
              "tokenize", "search", "search.encode", "search.level",
              "search.children_mask", "attn.fwd", "attn.bwd", "search.prefill", "mla.prefill",
              "mla.decode", "moe.route", "moe.experts", "moe.shared", "mlp.dense")
COUNTERS = ("data.item_slots", "data.valid_items", "comm.all_reduce_bytes", "moe.pairs",
            "moe.expert_pairs_max", "moe.experts_touched", "mla.cache_tokens")

_on = False
_spans: list = []
_counters: dict = {}
_ids = itertools.count(1)
_lock = threading.Lock()   # the recorded lists and counters, across threads
_local = threading.local()
_threads: dict = {}   # OS thread id -> threading.get_ident() of every thread that opened a span
_anchor = None   # (perf_counter_ns, time_ns) at enable() or the last collect()


class _Off:
    """The shared no-op span of recording off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()


def _stack() -> list:
    """This thread's open spans (and its OS thread id, read once)."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
        _local.tid = threading.get_native_id()   # a system call: read once a thread
        with _lock:
            _threads[_local.tid] = threading.get_ident()
    return stack


class _Span:
    __slots__ = ("name", "args", "start", "id", "parent", "request")

    def __init__(self, name: str, args: dict):
        self.name, self.args = name, args

    def __enter__(self):
        stack = _stack()
        top = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent, self.request = (top.id, top.request) if top else (0, self.id)
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _stack().pop()
        if _on:
            record = (self.name, self.start, end, self.id, self.parent, self.request, _local.tid,
                      self.args)
            with _lock:
                _spans.append(record)
        return False


def span(name: str, **args):
    """A context manager recording one span (the shared no-op when off)."""
    if not _on:
        return OFF
    return _Span(name, args)


def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name`` (nothing when off). ``n`` may be a
    0-d tensor on the device: the sum then stays there, and is read once,
    when collected, so a site need not wait for the device."""
    if not _on:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def enabled() -> bool:
    return _on


def _now():
    return time.perf_counter_ns(), time.time_ns()


def enable() -> None:
    """Start recording (a no-op when on)."""
    global _on, _anchor
    if not _on:
        _anchor = _now()
        _on = True


def disable() -> None:
    """Stop recording; what was recorded stays until ``collect()``."""
    global _on
    _on = False


def collect() -> dict:
    """What was recorded since the last collection, cleared:
    ``{"spans": [tuples of SPAN_FIELDS, times in Unix ns], "counters":
    {name: total}, "threads": {OS thread id: threading.get_ident()}}``;
    the last is every thread that has opened a span (a CUDA profiler trace
    names a runtime call's thread by its ``get_ident``, cut to 32 bits).
    Spans still open are left out (they are recorded when they close, if
    recording is still on)."""
    global _spans, _counters, _anchor
    with _lock:
        spans, counters = _spans, _counters
        _spans, _counters = [], {}
    counters = {k: v.item() if isinstance(v, torch.Tensor) else v for k, v in counters.items()}
    now = _now()
    p0, u0 = _anchor or now
    p1, u1 = now
    rate = (u1 - u0) / (p1 - p0) if p1 > p0 else 1.0
    if abs(rate - 1.0) > 1e-3:   # the wall clock was set meanwhile: keep the first anchor
        rate = 1.0
    _anchor = now
    out = [(s[0], u0 + round((s[1] - p0) * rate), u0 + round((s[2] - p0) * rate)) + s[3:]
           for s in spans]
    out.sort(key=lambda s: s[1])
    with _lock:
        threads = dict(_threads)
    return {"spans": out, "counters": counters, "threads": threads}


def add_spans_to_chrome_trace(path: str, spans: list, counters: Optional[dict] = None,
                              at_ns: Optional[int] = None) -> int:
    """Write ``spans`` (``collect()``'s) into the chrome trace at ``path``
    as ``X`` events of ``cat`` ``program_span`` on their threads, on the
    trace's clock, and each of ``counters`` as a ``C`` event of its total
    at ``at_ns`` (Unix ns); returns how many spans were written."""
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    events = trace.setdefault("traceEvents", [])
    for name, start, end, sid, parent, request, tid, args in spans:
        events.append({"ph": "X", "cat": "program_span", "name": name, "pid": pid, "tid": tid,
                       "ts": (start - base) / 1e3, "dur": (end - start) / 1e3,
                       "args": {**args, "span_id": sid, "parent_id": parent,
                                "request_id": request}})
    for name, total in (counters or {}).items():
        events.append({"ph": "C", "cat": "program_counter", "name": name, "pid": pid,
                       "ts": (at_ns - base) / 1e3, "args": {name: total}})
    with open(path, "w") as f:
        json.dump(trace, f)
    return len(spans)


class StepProfiler:
    """Starts a trace at step ``start`` and stops it after ``num_steps``
    steps. No-op when ``trace_dir`` is None. ``device`` decides whether the
    CUDA activity is traced (the loop's device; CUDA when it is one). Span
    recording is on while the window is open (and switched off, what it
    recorded cleared, when it closes); the trace holds its spans and
    counters."""

    def __init__(self, trace_dir: Optional[str], start: int = 10, num_steps: int = 5,
                 device=None):
        self.trace_dir = trace_dir
        self.start = start
        self.stop_after = start + num_steps
        self._cuda = torch.device(device).type == "cuda" if device is not None else False
        self._prof = None
        self._window = ([], {}, 0)   # the closed window's spans, counters and end (Unix ns)

    def step(self, it: int) -> None:
        if self.trace_dir is None:
            return
        if it == self.start and self._prof is None:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self._cuda:
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities, on_trace_ready=self._export)
            self._prof.start()
            enable()
        elif it >= self.stop_after and self._prof is not None:
            self.close()

    def _export(self, prof) -> None:
        os.makedirs(self.trace_dir, exist_ok=True)
        path = os.path.join(self.trace_dir,
                            f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(path)
        add_spans_to_chrome_trace(path, *self._window)
        self._window = ([], {}, 0)

    def close(self) -> None:
        if self._prof is not None:
            if self._cuda:
                torch.cuda.synchronize()
            got = collect()
            self._window = (got["spans"], got["counters"], time.time_ns())
            disable()
            self._prof.stop()
            self._prof = None
