"""Weight bridge from the JAX package's parameters to the port's.

The port keeps the JAX pytree layout (nested dicts / lists, weights (in, out)),
so conversion is a leaf-by-leaf copy:

* ``from_numpy`` takes a parameter tree of numpy arrays, e.g.
  ``jax.device_get(rqvae.init(...))`` or ``retrieval.init(...)``, and returns
  the same tree of tensors on ``device``.
* ``adamw_state_from_numpy`` takes an ``optax.adamw`` state as numpy (e.g.
  ``jax.device_get(opt.init(params))``) and returns the port's
  ``AdamWState``: the count and the ``ScaleByAdamState`` moments.
* ``load_pretrained`` reads a directory written by the JAX package's
  ``models/io.py:save_pretrained`` ({model_config.json, step_0/}) and returns
  (params, config) of the port. It reads the npz layout directly and the
  Orbax (OCDBT + zarr) layout through ``tensorstore``.

Nothing here imports JAX: callers hand over numpy arrays or files.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Tuple

import numpy as np
import torch

from rqvae_tpu_torch.models import retrieval, rqvae
from rqvae_tpu_torch.train.optim import AdamWState
from rqvae_tpu_torch.utils.device import resolve_device
from rqvae_tpu_torch.utils.tree import tree_leaves_with_path, tree_map

_KINDS = {
    "rqvae": (rqvae.RqVaeConfig, rqvae.init),
    "retrieval": (retrieval.RetrievalConfig, retrieval.init),
}


def _to_tensor(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: no numpy-native torch route
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def from_numpy(tree, *, device=None, dtype=None):
    """Numpy parameter tree -> the same tree of tensors on ``device`` (cuda
    unless the caller says otherwise); floating leaves cast to ``dtype``
    when given."""
    dev = resolve_device(device)
    return tree_map(lambda a: _to_tensor(a, dev, dtype), tree)


def adamw_state_from_numpy(state, *, device=None) -> AdamWState:
    """optax.adamw state (a tuple whose first element carries ``count``,
    ``mu`` and ``nu``) -> ``AdamWState`` on ``device``; the moments keep
    their dtype (fp32)."""
    adam = next(s for s in state if hasattr(s, "mu") and hasattr(s, "nu"))
    return AdamWState(int(adam.count), from_numpy(adam.mu, device=device),
                      from_numpy(adam.nu, device=device))


def _config_from_dict(kind: str, d: dict):
    """Port config of ``kind`` ("rqvae" / "retrieval") from a JSON dict;
    unknown keys are ignored."""
    cls = _KINDS[kind][0]
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in names})


def _orbax_arrays(state_dir: str, paths) -> Dict[tuple, np.ndarray]:
    try:
        import tensorstore as ts
    except ImportError as e:
        raise RuntimeError(
            f"{state_dir} is an Orbax checkpoint and reading it needs the tensorstore "
            "package; save with the npz backend instead"
        ) from e
    base = {"driver": "ocdbt", "base": "file://" + os.path.abspath(state_dir)}
    out = {}
    for path in paths:
        name = ".".join(["params", *(str(p) for p in path)])
        spec = {"driver": "zarr", "kvstore": base, "path": name}
        out[path] = np.asarray(ts.open(spec, open=True).result().read().result())
    return out


def load_pretrained(path: str, *, device=None) -> Tuple[dict, object]:
    """(params, config) from a JAX ``save_pretrained`` directory."""
    with open(os.path.join(path, "model_config.json")) as f:
        meta = json.load(f)
    kind = meta["kind"]
    cfg = _config_from_dict(kind, meta["config"])
    # the structure (and JAX's flatten order: sorted dict keys) comes from a
    # CPU template of the same config
    template = _KINDS[kind][1](torch.Generator(), cfg, device="cpu")
    paths = [p for p, _ in tree_leaves_with_path(template)]
    step_dir = os.path.join(path, "step_0")
    npz = os.path.join(step_dir, "state.npz")
    if os.path.exists(npz):
        with np.load(npz, allow_pickle=False) as z:
            arrays = {p: z[f"arr_{i}"] for i, p in enumerate(paths)}
    else:
        arrays = _orbax_arrays(os.path.join(step_dir, "state"), paths)
    for p, leaf in tree_leaves_with_path(template):
        if tuple(arrays[p].shape) != tuple(leaf.shape):
            raise ValueError(f"{'/'.join(map(str, p))}: checkpoint shape "
                             f"{arrays[p].shape}, config expects {tuple(leaf.shape)}")

    def fill(node, prefix=()):
        if isinstance(node, dict):
            return {k: fill(v, prefix + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [fill(v, prefix + (i,)) for i, v in enumerate(node)]
        return arrays[prefix]

    return from_numpy(fill(template), device=device), cfg
