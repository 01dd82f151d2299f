"""Checkpoint save / restore with auto-resume from the latest step
(counterpart of rqvae_tpu/train/checkpoint.py, in the torch format).

Layout: ``<root>/step_<N>/`` holds ``state.pt`` (``torch.save`` of
``{"params", "opt_state"}``, the AdamW state as a plain dict), ``meta.json``
(``{"step", **meta}``, e.g. the config) and ``DONE``. Each file is written
to a temporary name and moved into place with ``os.replace``, and ``DONE``
comes last, so ``latest_step`` never picks a half-written step.

Under a mesh of several ranks (``parallel/mesh``) only rank 0 writes; every
rank waits at a barrier before ``save`` returns and before ``restore`` reads,
and every rank restores. With one rank the barriers are identities. A
checkpoint always holds the whole layout: under tensor parallelism ``save``
gathers the shards of the params and the Adam moments over the model group
first (``spec_fn``; a collective every rank calls), and the loops shard what
``restore`` returns, so a checkpoint restores into any mesh.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Callable, Optional, Tuple

import torch

from rqvae_tpu_torch.parallel import mesh as mesh_lib
from rqvae_tpu_torch.train.optim import AdamWState

_STEP_RE = re.compile(r"^step_(\d+)$")


def _step_dir(root: str, step: int) -> str:
    return os.path.abspath(os.path.join(root, f"step_{step}"))


def latest_step(root: str) -> Optional[int]:
    if not os.path.isdir(root):
        return None
    steps = [
        int(m.group(1))
        for name in os.listdir(root)
        if (m := _STEP_RE.match(name)) and os.path.exists(os.path.join(root, name, "DONE"))
    ]
    return max(steps) if steps else None


def _to_plain(tree):
    if isinstance(tree, AdamWState):
        return {"count": tree.count, "mu": tree.mu, "nu": tree.nu}
    if isinstance(tree, dict):
        return {k: _to_plain(v) for k, v in tree.items()}
    return tree


def _write_atomic(path: str, write) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    write(tmp)
    os.replace(tmp, path)


def _write_text(path: str, text: str) -> None:
    def write(p):
        with open(p, "w") as f:
            f.write(text)

    _write_atomic(path, write)


def save(root: str, step: int, state: Any, meta: Optional[dict] = None,
         spec_fn: Optional[Callable] = None) -> str:
    """``state``: e.g. ``{"params": ..., "opt_state": AdamWState}``; written
    by rank 0, every rank returns after it is on disk. ``spec_fn`` (a
    ``parallel/mesh`` layout) gathers tensor-parallel shards to the whole
    layout first."""
    if spec_fn is not None:
        state = mesh_lib.gather_state(state, spec_fn)
    path = _step_dir(root, step)
    if mesh_lib.rank() == 0:
        os.makedirs(path, exist_ok=True)
        _write_atomic(os.path.join(path, "state.pt"),
                      lambda p: torch.save(_to_plain(state), p))
        _write_text(os.path.join(path, "meta.json"), json.dumps({"step": step, **(meta or {})}))
        _write_text(os.path.join(path, "DONE"), "ok")
    mesh_lib.barrier()
    return path


def restore(root: str, step: Optional[int] = None, *,
            device=None) -> Tuple[dict, dict]:
    """(state, meta) of ``step`` (the latest when None); tensors land on
    ``device`` and an ``opt_state`` comes back as an ``AdamWState``."""
    mesh_lib.barrier()
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    path = _step_dir(root, step)
    state = torch.load(os.path.join(path, "state.pt"), map_location=device, weights_only=True)
    if isinstance(state.get("opt_state"), dict):
        state["opt_state"] = AdamWState(**state["opt_state"])
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return state, meta
