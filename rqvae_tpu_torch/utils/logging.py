"""Metrics sinks (counterpart of rqvae_tpu/utils/logging.py, the same
signature): JSONL records on a stream (stdout by default) or appended to a
file, plus an optional TensorBoard event stream. Every record is
``{"step", "wall_s", **metrics}``, with the JAX package's metric names; the
JSONL stream is never turned off.

``sink="tensorboard"`` also writes every float scalar through
``torch.utils.tensorboard.SummaryWriter``, imported only when that sink is
asked for: it needs the ``tensorboard`` package, which a machine may lack.
Its directory defaults to ``<dir of path>/tb``.
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import IO, Optional

SINKS = ("jsonl", "tensorboard")


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, stream: Optional[IO] = None,
                 every: int = 1, sink: str = "jsonl",
                 tensorboard_dir: Optional[str] = None):
        if sink not in SINKS:
            raise ValueError(f"unknown metrics sink {sink!r} (use {SINKS})")
        self._file = open(path, "a") if path else None
        self._stream = stream if stream is not None else sys.stdout
        self._every = max(1, every)
        self._t0 = time.monotonic()
        self._tb = None
        if sink == "tensorboard":
            from torch.utils.tensorboard import SummaryWriter

            tb_dir = tensorboard_dir or (os.path.join(os.path.dirname(path), "tb")
                                         if path else "tb")
            self._tb = SummaryWriter(log_dir=tb_dir)

    def log(self, step: int, metrics: dict, force: bool = False) -> None:
        if not force and step % self._every:
            return
        record = {
            "step": int(step),
            "wall_s": round(time.monotonic() - self._t0, 3),
            **{k: _jsonable(v) for k, v in metrics.items()},
        }
        line = json.dumps(record)
        if self._file:
            self._file.write(line + "\n")
            self._file.flush()
        else:
            print(line, file=self._stream, flush=True)
        if self._tb is not None:
            for k, v in record.items():
                if k != "step" and isinstance(v, float):
                    self._tb.add_scalar(k, v, global_step=int(step))

    def close(self) -> None:
        if self._file:
            self._file.close()
        if self._tb is not None:
            self._tb.close()


def _jsonable(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)
