"""Step-windowed trace capture on ``torch.profiler`` behind the train loops'
``profile_dir`` / ``profile_start`` / ``profile_steps`` fields (counterpart
of rqvae_tpu/utils/profiling.py, the same constructor and behaviour).

The trace records the host's operators, and the device's kernels and copies
when the loop runs on CUDA. It is written by
``torch.profiler.tensorboard_trace_handler(trace_dir)`` as a Chrome trace
JSON file (``<host>_<pid>.<time>.pt.trace.json``, one a rank under data
parallelism; no ``tensorboard`` package needed to write it), which
TensorBoard's profiler plugin or ``chrome://tracing`` reads.

Before the trace stops, the device is synchronised, so every kernel the
window enqueued has finished and is in the trace: that costs one host sync
at the window's end, and nothing on steps outside the window.
"""
from __future__ import annotations

from typing import Optional

import torch


class StepProfiler:
    """Starts a trace at step ``start`` and stops it after ``num_steps``
    steps. No-op when ``trace_dir`` is None. ``device`` decides whether the
    CUDA activity is traced (the loop's device; CUDA when it is one)."""

    def __init__(self, trace_dir: Optional[str], start: int = 10, num_steps: int = 5,
                 device=None):
        self.trace_dir = trace_dir
        self.start = start
        self.stop_after = start + num_steps
        self._cuda = torch.device(device).type == "cuda" if device is not None else False
        self._prof = None

    def step(self, it: int) -> None:
        if self.trace_dir is None:
            return
        if it == self.start and self._prof is None:
            from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

            activities = [ProfilerActivity.CPU]
            if self._cuda:
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities,
                                 on_trace_ready=tensorboard_trace_handler(self.trace_dir))
            self._prof.start()
        elif it >= self.stop_after and self._prof is not None:
            self.close()

    def close(self) -> None:
        if self._prof is not None:
            if self._cuda:
                torch.cuda.synchronize()
            self._prof.stop()
            self._prof = None
