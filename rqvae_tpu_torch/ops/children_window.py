"""Windowed children extraction from a sorted prefix table (counterpart of
rqvae_tpu/ops/children_window.py:children_window).

For every beam row, the run ``table[lo : lo + cnt]`` of its children's keys
in the level's sorted distinct-key table becomes child tokens
(``key - key0``), with ``k_tokens`` at slots past the run or holding tokens
outside [0, k_tokens). The output is (R, W): slot j is the child at run
position j. (The TPU kernel's (R, W + 128) layout came from Mosaic's
128-aligned loads; the validity mask built from either is identical.)

``children_window`` launches the hand-written CUDA kernel
``csrc/children_window.cu`` for CUDA tensors and runs
``children_window_plain`` for CPU tensors; there is no fallback from one to
the other. ``children_window.launches`` counts kernel launches.

Keys are int64 (torch lacks sort / searchsorted on uint32); the JAX package
uses uint32 keys, which compare by value the same way.
"""
from __future__ import annotations

import ctypes

import torch


def children_window_plain(table: torch.Tensor, lo: torch.Tensor, cnt: torch.Tensor,
                          key0: torch.Tensor, *, window: int, k_tokens: int) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: (R, window) int32 child tokens."""
    n = table.shape[0]
    slot = torch.arange(window, device=table.device)
    pos = lo.long()[:, None] + slot
    in_run = (slot[None, :] < cnt.long()[:, None]) & (pos < n)
    keys = table[pos.clamp(0, n - 1)]
    child = keys - key0.long()[:, None]
    ok = in_run & (child >= 0) & (child < k_tokens)
    return torch.where(ok, child, k_tokens).to(torch.int32)


def _lib() -> ctypes.CDLL:
    from rqvae_tpu_torch.ops import _cuda_build

    lib = _cuda_build.load("children_window")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.children_window_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
        lib.children_window_launch.restype = i
        lib.children_window_error_string.argtypes = [i]
        lib.children_window_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def children_window(table: torch.Tensor, lo: torch.Tensor, cnt: torch.Tensor,
                    key0: torch.Tensor, *, window: int, k_tokens: int) -> torch.Tensor:
    """table (n,) int64 sorted distinct keys; lo, cnt (R,) int32 run starts
    and lengths; key0 (R,) int64 parent_rank * radix. Returns (R, window)
    int32 child tokens, ``k_tokens`` at invalid slots."""
    if table.dim() != 1 or lo.dim() != 1 or lo.shape != cnt.shape or lo.shape != key0.shape:
        raise ValueError(
            f"bad shapes: table {tuple(table.shape)}, lo {tuple(lo.shape)}, "
            f"cnt {tuple(cnt.shape)}, key0 {tuple(key0.shape)}"
        )
    if table.shape[0] == 0:
        raise ValueError("empty key table")
    devices = {t.device for t in (table, lo, cnt, key0)}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {devices}")
    if table.device.type == "cpu":
        return children_window_plain(table, lo, cnt, key0, window=window, k_tokens=k_tokens)
    if table.device.type != "cuda":
        raise ValueError(f"children_window runs on cuda (kernel) or cpu (plain), got {table.device}")
    if table.dtype != torch.int64 or key0.dtype != torch.int64:
        raise TypeError(f"table and key0 must be int64, got {table.dtype} / {key0.dtype}")
    if lo.dtype != torch.int32 or cnt.dtype != torch.int32:
        raise TypeError(f"lo and cnt must be int32, got {lo.dtype} / {cnt.dtype}")
    if not all(t.is_contiguous() for t in (table, lo, cnt, key0)):
        raise ValueError("children_window needs contiguous operands")
    r = lo.shape[0]
    out = torch.empty((r, window), dtype=torch.int32, device=table.device)
    if r == 0 or window == 0:
        return out
    lib = _lib()
    dev_index = table.device.index if table.device.index is not None \
        else torch.cuda.current_device()
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = lib.children_window_launch(
        table.data_ptr(), lo.data_ptr(), cnt.data_ptr(), key0.data_ptr(),
        out.data_ptr(), r, table.shape[0], window, k_tokens, dev_index, stream,
    )
    if err != 0:
        raise RuntimeError(
            f"children_window launch failed: {lib.children_window_error_string(err).decode()}"
        )
    children_window.launches += 1
    return out


children_window.launches = 0
