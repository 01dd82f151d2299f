"""Model-only save / load: share weights without the optimizer state (the
port's counterpart of rqvae_tpu/models/io.py).

A ``save_pretrained`` directory describes itself: ``model_config.json``
(``{"kind": "rqvae" | "retrieval", "config": {...}}``, the JAX package's
schema) beside ``step_0/``, a checkpoint of ``{"params"}`` in the port's
format (``train/checkpoint.py``). Whatever reads the directory rebuilds the
model without the training config that produced it. ``load_pretrained``
also reads the JAX package's directories (``step_0/state.npz`` or Orbax),
through ``convert.load_pretrained``, so a model the JAX package published
loads too.

``push_to_hub`` / ``load_pretrained_auto`` add the Hugging Face Hub leg
(``huggingface_hub``, imported inside them); an unreachable hub is a
``RuntimeError``, and the local directory stays the source of truth.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import torch

from rqvae_tpu_torch.models import convert, retrieval, rqvae
from rqvae_tpu_torch.parallel import mesh as mesh_lib
from rqvae_tpu_torch.train import checkpoint as ckpt_lib
from rqvae_tpu_torch.utils import config as config_lib
from rqvae_tpu_torch.utils.device import resolve_device
from rqvae_tpu_torch.utils.tree import tree_shapes

_SPECS = {"rqvae": mesh_lib.rqvae_tp_spec, "retrieval": mesh_lib.retrieval_tp_spec}
_KINDS = {
    "rqvae": (rqvae.RqVaeConfig, rqvae.init),
    "retrieval": (retrieval.RetrievalConfig, retrieval.init),
}


def save_pretrained(path: str, params, cfg) -> str:
    """Write {params, model config, kind} under ``path`` (the step_0 layout);
    the tensors are stored on the CPU, whole: tensor-parallel shards are
    gathered first (a collective every rank calls), as checkpoints are."""
    kind = next((k for k, (cls, _) in _KINDS.items() if isinstance(cfg, cls)), None)
    if kind is None:
        raise TypeError(f"unsupported config type: {type(cfg)}")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "model_config.json"), "w") as f:
        json.dump({"kind": kind, "config": config_lib.config_to_dict(cfg)}, f)
    whole = mesh_lib.fetch_to_host(params, _SPECS[kind])
    ckpt_lib.save(path, 0, {"params": whole})
    return path


def load_pretrained(path: str, *, device=None) -> Tuple[dict, object]:
    """(params, model config) from a ``save_pretrained`` directory of either
    package, the params on ``device`` (the GPU unless told otherwise)."""
    dev = resolve_device(device)
    if not os.path.exists(os.path.join(path, "step_0", "state.pt")):
        return convert.load_pretrained(path, device=dev)   # the JAX package's layout
    with open(os.path.join(path, "model_config.json")) as f:
        meta = json.load(f)
    cfg_cls, init_fn = _KINDS[meta["kind"]]
    cfg = config_lib.from_dict(cfg_cls, meta["config"])
    state, _ = ckpt_lib.restore(path, step=0, device=dev)
    params = state["params"]
    if tree_shapes(params) != tree_shapes(init_fn(torch.Generator(), cfg, device="cpu")):
        raise ValueError(f"the params at {path} do not fit their config ({cfg})")
    return params, cfg


def push_to_hub(local_dir: str, repo_id: str, *, private: bool = True,
                token: Optional[str] = None) -> str:
    """Upload a ``save_pretrained`` directory as a hub model repo; returns
    the repo's URL. An unreachable hub raises a ``RuntimeError``."""
    try:
        from huggingface_hub import HfApi
    except ImportError as e:
        raise RuntimeError("huggingface_hub is not installed") from e
    api = HfApi(token=token)
    try:
        api.create_repo(repo_id, private=private, exist_ok=True)
        api.upload_folder(folder_path=local_dir, repo_id=repo_id)
    except Exception as e:
        raise RuntimeError(
            f"hub push of {local_dir!r} to {repo_id!r} failed (no network?): {e}"
        ) from e
    return f"https://huggingface.co/{repo_id}"


def load_pretrained_auto(path_or_repo: str, *, token: Optional[str] = None,
                         revision: Optional[str] = None, device=None):
    """``load_pretrained`` of a local directory or of a hub repo id (a
    snapshot is downloaded, then read locally)."""
    if os.path.isdir(path_or_repo):
        return load_pretrained(path_or_repo, device=device)
    try:
        from huggingface_hub import snapshot_download
    except ImportError as e:
        raise RuntimeError("huggingface_hub is not installed") from e
    try:
        local = snapshot_download(path_or_repo, token=token, revision=revision)
    except Exception as e:
        raise RuntimeError(
            f"{path_or_repo!r} is neither a local save_pretrained directory "
            f"nor a reachable hub repo: {e}"
        ) from e
    return load_pretrained(local, device=device)
