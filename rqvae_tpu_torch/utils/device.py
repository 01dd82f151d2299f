"""Device policy of the port: the GPU unless the caller asks for the CPU;
under ``torchrun`` the GPU of the process's ``LOCAL_RANK``."""
from __future__ import annotations

import os
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``cuda:$LOCAL_RANK`` when ``LOCAL_RANK`` is set (one
    process a GPU, as ``torchrun`` starts them), else ``cuda``. Asking for
    CUDA without a GPU raises: nothing silently carries on on the CPU."""
    if device is None:
        local = os.environ.get("LOCAL_RANK")
        device = f"cuda:{int(local)}" if local is not None else "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "rqvae_tpu_torch runs on CUDA by default and no GPU is visible; "
            'pass device="cpu" to run on the CPU explicitly'
        )
    return dev
