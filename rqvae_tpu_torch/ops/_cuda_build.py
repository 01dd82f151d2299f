"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into
``<build dir>/<name>-<source hash>.so`` at first use, then loaded with
ctypes. The hash covers the source and every shared header (``csrc/*.cuh``),
so a stale library is impossible to load. ``build_all`` starts one nvcc per source at once and waits for all.

The build directory is ``build/kernels`` beside the package (listed in
``.gitignore``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from source at first use")


def _target(name: str) -> Tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    text = src.read_bytes() + b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(text + " ".join(ARCH_FLAGS).encode()).hexdigest()[:12]
    return src, BUILD_DIR / f"{name}-{digest}.so"


def _start_build(name: str):
    """Start nvcc for ``name`` unless its library exists; returns
    (Popen or None, output path, temporary path)."""
    src, out = _target(name)
    if out.exists():
        return None, out, None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v",
           "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out, tmp


def _finish_build(name: str, proc, out: Path, tmp) -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def build_all(names: List[str]) -> Dict[str, str]:
    """Compile every named kernel in parallel; returns nvcc's log per name
    (registers / shared memory from ``-Xptxas -v``; empty when cached)."""
    with _LOCK:
        started = {n: _start_build(n) for n in names}
        return {n: _finish_build(n, *started[n]) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(_target(name)[1]))
        return _LIBS[name]
