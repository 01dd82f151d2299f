"""Native host-side components (counterpart of rqvae_tpu/native/): the data
loader's random-crop batcher, plain C (``batcher.c``, the port's own copy of
the JAX package's) loaded through ctypes.

The library is built at first use with the system C compiler (``cc``,
``gcc`` or ``clang``, the first found) into ``build/native/`` beside the
package (listed in ``.gitignore``), named by a hash of the source. The
compiler writes a temporary file that is then moved into place with
``os.replace``, so a process never loads a half-written library while
another builds it. A failed build raises, and so does a machine with no C
compiler: nothing falls back quietly. The Python crop path
(``SeqDataset._subsample_row``) runs only when ``RQVAE_TPU_DISABLE_NATIVE=1``
asks for it, the JAX package's own switch (JAX also falls back when it finds
no compiler; the port does not).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

DISABLE_ENV = "RQVAE_TPU_DISABLE_NATIVE"
SRC = Path(__file__).resolve().parent / "batcher.c"
BUILD_DIR = SRC.parent.parent.parent / "build" / "native"
CFLAGS = ("-O3", "-shared", "-fPIC")

_LOCK = threading.Lock()


def enabled() -> bool:
    """False when ``RQVAE_TPU_DISABLE_NATIVE`` is ``"1"`` (read at each call)."""
    return os.environ.get(DISABLE_ENV, "0") != "1"


def _compiler() -> str:
    for cc in ("cc", "gcc", "clang"):
        path = shutil.which(cc)
        if path:
            return path
    raise RuntimeError("no C compiler (cc, gcc or clang) on PATH for the native batcher; "
                       f"set {DISABLE_ENV}=1 to crop on the Python path")


def _build() -> Path:
    text = SRC.read_bytes()
    digest = hashlib.sha1(text + " ".join(CFLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"batcher-{digest}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([_compiler(), *CFLAGS, "-o", str(tmp), str(SRC)],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SRC.name} failed (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def available() -> bool:
    """Whether ``subsample_batch`` can run: the switch is on (``enabled``)
    and the library builds and loads. The one place a failed build becomes
    a value (``_load`` raises); no path picks its route by it."""
    if not enabled():
        return False
    try:
        _load()
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return False
    return True


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    """The library, built if needed, its entry point typed."""
    with _LOCK:
        lib = ctypes.CDLL(str(_build()))
    lib.subsample_batch.restype = None
    lib.subsample_batch.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int64, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    return lib


def subsample_batch(item_ids: np.ndarray, item_ids_fut: np.ndarray, idx: np.ndarray,
                    max_seq_len: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Random crops of the rows ``idx`` of ``item_ids`` (n_rows, row_len)
    int32, -1 tail-padded, with targets ``item_ids_fut`` (n_rows,) or
    (n_rows, 1): (ids (B, max_seq_len) int32, -1 padded; targets (B,) int32).
    The draws are SplitMix64 from ``seed``."""
    item_ids = np.ascontiguousarray(item_ids, np.int32)
    fut = np.ascontiguousarray(item_ids_fut, np.int32).reshape(-1)
    idx = np.ascontiguousarray(idx, np.int64)
    if item_ids.ndim != 2 or fut.shape[0] != item_ids.shape[0]:
        raise ValueError(f"item_ids {item_ids.shape} and item_ids_fut {fut.shape} disagree")
    if idx.ndim != 1 or (idx.size and (idx.min() < 0 or idx.max() >= item_ids.shape[0])):
        raise ValueError(f"row indices out of range for {item_ids.shape[0]} rows")
    lib = _load()
    out_ids = np.empty((idx.shape[0], max_seq_len), np.int32)
    out_fut = np.empty((idx.shape[0],), np.int32)
    i32 = ctypes.POINTER(ctypes.c_int32)
    lib.subsample_batch(
        item_ids.ctypes.data_as(i32), fut.ctypes.data_as(i32),
        item_ids.shape[0], item_ids.shape[1],
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), idx.shape[0],
        max_seq_len, ctypes.c_uint64(seed & (2**64 - 1)),
        out_ids.ctypes.data_as(i32), out_fut.ctypes.data_as(i32),
    )
    return out_ids, out_fut
