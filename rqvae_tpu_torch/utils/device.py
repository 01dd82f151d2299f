"""Device policy of the port: the GPU unless the caller asks for the CPU."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``cuda``. Asking for CUDA without a GPU raises: nothing
    silently carries on on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "rqvae_tpu_torch runs on CUDA by default and no GPU is visible; "
            'pass device="cpu" to run on the CPU explicitly'
        )
    return dev
