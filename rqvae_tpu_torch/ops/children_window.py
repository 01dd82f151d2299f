"""Windowed children extraction from a sorted prefix table (counterpart of
rqvae_tpu/ops/children_window.py:children_window), and its fold into the
beam search's validity mask.

For every beam row, the run ``table[lo : lo + cnt]`` of its children's keys
in the level's sorted distinct-key table becomes child tokens
(``key - key0``), with ``k_tokens`` at slots past the run or the table, or
holding tokens outside [0, k_tokens). The output is (R, W): slot j is the
child at run position j. (The TPU kernel's (R, W + 128) layout came from
Mosaic's 128-aligned loads; the validity mask built from either is
identical.)

Two wrappers launch the two epilogues of the hand-written CUDA kernel
``csrc/children_window.cu`` for CUDA tensors and run their plain twins for
CPU tensors; there is no fallback from one to the other:

* ``children_window`` (``Tokens``): the (R, W) int32 child tokens, the TPU
  kernel's function; twin ``children_window_plain``.
* ``children_window_mask`` (``Mask``): the (R, k_tokens) bool mask of the
  children present, the one-hot fold ``semids.children_mask`` applies to
  the tokens, done in the kernel's epilogue; twin
  ``children_window_mask_plain``. The kernel keeps each warp's K-bit set in
  shared memory, so on CUDA k_tokens is capped at ``MASK_MAX_K``; the twin
  takes any k_tokens.

Each counts its kernel launches on ``.launches``. A launch asks the host for
no state but the tensors' device index and current stream: the library is
loaded and typed once, and the C entry sets the device only when it differs
and asks for its persistent grid once per device.

Keys are int64 (torch lacks sort / searchsorted on uint32); the JAX package
uses uint32 keys, which compare by value the same way.
"""
from __future__ import annotations

import ctypes
import functools

import torch

# The Mask kernel's 8 warp bitmaps of ceil(K / 32) words in an sm_90 block's
# 227 KB of opt-in shared memory (csrc/children_window.cu).
MASK_MAX_K = 232_448


def children_window_plain(table: torch.Tensor, lo: torch.Tensor, cnt: torch.Tensor,
                          key0: torch.Tensor, *, window: int, k_tokens: int) -> torch.Tensor:
    """Plain PyTorch twin of the ``Tokens`` epilogue: (R, window) int32
    child tokens."""
    n = table.shape[0]
    slot = torch.arange(window, device=table.device)
    pos = lo.long()[:, None] + slot
    in_run = (slot[None, :] < cnt.long()[:, None]) & (pos >= 0) & (pos < n)
    keys = table[pos.clamp(0, n - 1)]
    child = keys - key0.long()[:, None]
    ok = in_run & (child >= 0) & (child < k_tokens)
    return torch.where(ok, child, k_tokens).to(torch.int32)


def fold_tokens(child: torch.Tensor, k_tokens: int) -> torch.Tensor:
    """(R, W) child tokens -> (R, k_tokens) bool mask of the tokens present:
    scattered into a (R, k_tokens + 1) mask whose last column (the invalid
    token) is dropped."""
    hits = torch.zeros((child.shape[0], k_tokens + 1), dtype=torch.bool, device=child.device)
    hits.scatter_(1, child.long(), True)
    return hits[:, :k_tokens]


def children_window_mask_plain(table: torch.Tensor, lo: torch.Tensor, cnt: torch.Tensor,
                               key0: torch.Tensor, *, window: int, k_tokens: int) -> torch.Tensor:
    """Plain PyTorch twin of the ``Mask`` epilogue: ``children_window_plain``
    then ``fold_tokens``."""
    return fold_tokens(children_window_plain(table, lo, cnt, key0, window=window,
                                             k_tokens=k_tokens), k_tokens)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel library (built at first use), its entry points typed once."""
    from rqvae_tpu_torch.ops import _cuda_build

    lib = _cuda_build.load("children_window")
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in ("children_window_launch", "children_window_mask_launch"):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [p, p, p, p, p, i, i, i, i, i, p], i
    lib.children_window_error_string.argtypes = [i]
    lib.children_window_error_string.restype = ctypes.c_char_p
    return lib


def _check(table, lo, cnt, key0) -> torch.device:
    """The operands' one device; raises on shapes, devices, dtypes or
    layouts the kernel does not take (on either device, so that the twins
    take what the kernel takes)."""
    if table.dim() != 1 or lo.dim() != 1 or lo.shape != cnt.shape or lo.shape != key0.shape:
        raise ValueError(
            f"bad shapes: table {tuple(table.shape)}, lo {tuple(lo.shape)}, "
            f"cnt {tuple(cnt.shape)}, key0 {tuple(key0.shape)}"
        )
    if table.shape[0] == 0:
        raise ValueError("empty key table")
    dev = table.device
    if lo.device != dev or cnt.device != dev or key0.device != dev:
        raise ValueError(f"operands on several devices: "
                         f"{ {t.device for t in (table, lo, cnt, key0)} }")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"children_window runs on cuda (kernel) or cpu (plain), got {dev}")
    if table.dtype != torch.int64 or key0.dtype != torch.int64:
        raise TypeError(f"table and key0 must be int64, got {table.dtype} / {key0.dtype}")
    if lo.dtype != torch.int32 or cnt.dtype != torch.int32:
        raise TypeError(f"lo and cnt must be int32, got {lo.dtype} / {cnt.dtype}")
    if not (table.is_contiguous() and lo.is_contiguous() and cnt.is_contiguous()
            and key0.is_contiguous()):
        raise ValueError("children_window needs contiguous operands")
    return dev


def _check_mask_k(k_tokens: int, dev: torch.device) -> None:
    """Raise on a token count the Mask epilogue does not take on ``dev``."""
    cuda = dev.type == "cuda"
    if k_tokens < 1 or (cuda and k_tokens > MASK_MAX_K):
        limit = f" <= {MASK_MAX_K}" if cuda else ""
        raise ValueError(f"children_window_mask on {dev.type} takes 1 <= k_tokens{limit}, "
                         f"got {k_tokens}")


def _launch(wrapper, entry: str, out, table, lo, cnt, key0, window: int, k_tokens: int):
    """Launch one epilogue on checked CUDA operands into ``out``; raise on
    the CUDA error code and count the launch on ``wrapper.launches``."""
    if out.numel() == 0:
        return out
    lib, index = _lib(), table.device.index
    err = getattr(lib, entry)(
        table.data_ptr(), lo.data_ptr(), cnt.data_ptr(), key0.data_ptr(), out.data_ptr(),
        lo.shape[0], table.shape[0], window, k_tokens, index,
        torch._C._cuda_getCurrentRawStream(index),   # the current stream's handle
    )
    if err != 0:
        raise RuntimeError(f"{wrapper.__name__} launch failed: "
                           f"{lib.children_window_error_string(err).decode()}")
    wrapper.launches += 1
    return out


def children_window(table: torch.Tensor, lo: torch.Tensor, cnt: torch.Tensor,
                    key0: torch.Tensor, *, window: int, k_tokens: int) -> torch.Tensor:
    """table (n,) int64 sorted distinct keys; lo, cnt (R,) int32 run starts
    and lengths; key0 (R,) int64 parent_rank * radix. Returns (R, window)
    int32 child tokens, ``k_tokens`` at invalid slots (the ``Tokens``
    epilogue)."""
    if _check(table, lo, cnt, key0).type == "cpu":
        return children_window_plain(table, lo, cnt, key0, window=window, k_tokens=k_tokens)
    out = torch.empty((lo.shape[0], window), dtype=torch.int32, device=table.device)
    return _launch(children_window, "children_window_launch", out, table, lo, cnt, key0,
                   window, k_tokens)


children_window.launches = 0


def children_window_mask(table: torch.Tensor, lo: torch.Tensor, cnt: torch.Tensor,
                         key0: torch.Tensor, *, window: int, k_tokens: int) -> torch.Tensor:
    """The operands of ``children_window``; returns the (R, k_tokens) bool
    mask of the child tokens its window holds (the ``Mask`` epilogue).
    k_tokens must be >= 1, and at most ``MASK_MAX_K`` on CUDA."""
    dev = _check(table, lo, cnt, key0)
    _check_mask_k(k_tokens, dev)
    if dev.type == "cpu":
        return children_window_mask_plain(table, lo, cnt, key0, window=window, k_tokens=k_tokens)
    out = torch.empty((lo.shape[0], k_tokens), dtype=torch.bool, device=table.device)
    return _launch(children_window_mask, "children_window_mask_launch", out, table, lo, cnt,
                   key0, window, k_tokens)


children_window_mask.launches = 0
