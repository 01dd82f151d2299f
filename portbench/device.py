"""The card a run measures, and what the run keeps away from it.

* ``require(chips)`` ends the process (exit 1, no result) when CUDA is
  missing or shows fewer cards than the cell asks for: a measurement never
  falls back to the CPU.
* ``describe()`` names the card (``torch.cuda.get_device_name``), the count
  and ``nvidia-smi``'s ``power.limit``.
* ``build_kernels()`` builds the port's CUDA libraries and its native
  batcher, each into its fixed directory inside the checkout
  (``build/kernels``, ``build/native``), so only a checkout's first run
  compiles.
* ``settle()`` points the toolchains' caches at fixed directories inside
  the checkout.
* ``forbidden_modules()`` lists the modules of JAX and of the JAX package a
  process has loaded, compared by whole top-level names.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "rqvae_tpu")
ROOT = Path(__file__).resolve().parent.parent


def process_seconds() -> float:
    """Seconds since this process started (Linux: /proc/self/stat)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def settle() -> None:
    """Before torch is imported: the toolchains' caches at fixed directories
    inside the checkout. PyTorch's host threads keep their defaults, as
    ``train()`` and a server run them."""
    cache = ROOT / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def require(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        print("portbench: CUDA is not available; a run measures the card only", file=sys.stderr)
        raise SystemExit(1)
    if torch.cuda.device_count() < chips:
        print(f"portbench: the cell asks for {chips} cards, {torch.cuda.device_count()} visible",
              file=sys.stderr)
        raise SystemExit(1)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def describe(count: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count}


def build_kernels() -> float:
    """Build (or find built) every CUDA library of the port and its native
    batcher; returns the seconds it took."""
    t0 = time.perf_counter()
    from rqvae_tpu_torch import native
    from rqvae_tpu_torch.ops import _cuda_build

    names = sorted(p.stem for p in _cuda_build.CSRC.glob("*.cu"))
    _cuda_build.build_all(names)
    for n in names:
        _cuda_build.load(n)
    if not native.available():
        raise RuntimeError("the native batcher did not build")
    return time.perf_counter() - t0


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)
