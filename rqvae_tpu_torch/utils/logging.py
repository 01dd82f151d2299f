"""Metrics sink: JSONL lines on a stream, stdout by default (counterpart of
rqvae_tpu/utils/logging.py without its file and TensorBoard sinks). Every
record is ``{"step", "wall_s", **metrics}``, with the JAX package's metric
names."""
from __future__ import annotations

import json
import sys
import time
from typing import IO, Optional


class MetricsLogger:
    def __init__(self, stream: Optional[IO] = None, every: int = 1):
        self._stream = stream if stream is not None else sys.stdout
        self._every = max(1, every)
        self._t0 = time.monotonic()

    def log(self, step: int, metrics: dict, force: bool = False) -> None:
        if not force and step % self._every:
            return
        record = {
            "step": int(step),
            "wall_s": round(time.monotonic() - self._t0, 3),
            **{k: _jsonable(v) for k, v in metrics.items()},
        }
        print(json.dumps(record), file=self._stream, flush=True)


def _jsonable(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)
