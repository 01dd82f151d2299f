"""Fused residual-quantization tokenize kernel (counterpart of
rqvae_tpu/ops/quantize_pallas.py:rq_tokenize).

``rq_tokenize`` launches the hand-written CUDA kernel ``csrc/rq_tokenize.cu``
for CUDA tensors and runs ``rq_tokenize_plain`` for CPU tensors; there is no
fallback from one to the other. The kernel replaces the TPU's ``_rq_kernel``;
its source note says what bounds it on an H100 and how it is laid out.
``rq_tokenize.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch


class RqTokenizeOutput(NamedTuple):
    sem_ids: torch.Tensor   # (B, L) int32
    emb_sum: torch.Tensor   # (B, D) sum of selected codewords over levels
    residual: torch.Tensor  # (B, D) final residual (x - emb_sum)
    loss: torch.Tensor      # (B,) summed (1+beta)*||res_l - emb_l||^2


def rq_tokenize_plain(x: torch.Tensor, codebooks: torch.Tensor, *,
                      commitment_weight: float = 0.25) -> RqTokenizeOutput:
    """Plain PyTorch twin of the kernel, same arithmetic in fp32:
    ||r||^2 - 2 r.cb + ||cb||^2, argmin (first index on ties), gather."""
    res = x.float()
    cbs = codebooks.float()
    emb_sum = torch.zeros_like(res)
    loss = torch.zeros(res.shape[0], dtype=torch.float32, device=res.device)
    ids = []
    for level in range(cbs.shape[0]):
        cb = cbs[level]
        dist = (
            torch.sum(res * res, dim=-1, keepdim=True) - 2.0 * (res @ cb.T)
        ) + torch.sum(cb * cb, dim=-1)[None, :]
        idx = torch.argmin(dist, dim=-1)
        emb = cb[idx]
        diff = res - emb
        loss = loss + (1.0 + commitment_weight) * torch.sum(diff * diff, dim=-1)
        emb_sum = emb_sum + emb
        res = diff
        ids.append(idx.to(torch.int32))
    return RqTokenizeOutput(torch.stack(ids, dim=-1), emb_sum, res, loss)


def _lib() -> ctypes.CDLL:
    from rqvae_tpu_torch.ops import _cuda_build

    lib = _cuda_build.load("rq_tokenize")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rq_tokenize_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, ctypes.c_float, i, p]
        lib.rq_tokenize_launch.restype = i
        lib.rq_tokenize_smem_bytes.argtypes = [i, i, i]
        lib.rq_tokenize_smem_bytes.restype = ctypes.c_longlong
        lib.rq_tokenize_max_d.restype = i
        lib.rq_tokenize_max_smem.argtypes = [i]
        lib.rq_tokenize_max_smem.restype = ctypes.c_longlong
        lib.rq_tokenize_error_string.argtypes = [i]
        lib.rq_tokenize_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def rq_tokenize(x: torch.Tensor, codebooks: torch.Tensor, *,
                commitment_weight: float = 0.25) -> RqTokenizeOutput:
    """Multi-level residual quantization, hard argmin. x (B, D) fp32,
    codebooks (L, K, D) fp32 (effective, post SimVQ / l2-norm)."""
    if x.dim() != 2 or codebooks.dim() != 3 or x.shape[1] != codebooks.shape[2]:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, codebooks {tuple(codebooks.shape)}")
    if x.device != codebooks.device:
        raise ValueError(f"x on {x.device}, codebooks on {codebooks.device}")
    if x.device.type == "cpu":
        return rq_tokenize_plain(x, codebooks, commitment_weight=commitment_weight)
    if x.device.type != "cuda":
        raise ValueError(f"rq_tokenize runs on cuda (kernel) or cpu (plain), got {x.device}")
    if x.dtype != torch.float32 or codebooks.dtype != torch.float32:
        raise TypeError(f"rq_tokenize takes float32, got {x.dtype} / {codebooks.dtype}")
    if not (x.is_contiguous() and codebooks.is_contiguous()):
        raise ValueError("rq_tokenize needs contiguous x and codebooks")
    b, d = x.shape
    n_levels, k, _ = codebooks.shape
    lib = _lib()
    if d > lib.rq_tokenize_max_d():
        raise ValueError(f"rq_tokenize supports D <= {lib.rq_tokenize_max_d()}, got {d}")
    dev_index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    limit = lib.rq_tokenize_max_smem(dev_index)
    smem = lib.rq_tokenize_smem_bytes(n_levels, k, d)
    if smem > limit:
        raise ValueError(
            f"codebook stack {n_levels}x{k}x{d} needs {smem} B of shared memory, the "
            f"block may use {limit} B; this size needs a K-tiled kernel"
        )
    ids = torch.empty((b, n_levels), dtype=torch.int32, device=x.device)
    emb = torch.empty((b, d), dtype=torch.float32, device=x.device)
    res = torch.empty((b, d), dtype=torch.float32, device=x.device)
    loss = torch.empty((b,), dtype=torch.float32, device=x.device)
    if b == 0:
        return RqTokenizeOutput(ids, emb, res, loss)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.rq_tokenize_launch(
        x.data_ptr(), codebooks.data_ptr(), ids.data_ptr(), emb.data_ptr(),
        res.data_ptr(), loss.data_ptr(), b, n_levels, k, d,
        float(commitment_weight), dev_index, stream,
    )
    if err != 0:
        raise RuntimeError(f"rq_tokenize launch failed: {lib.rq_tokenize_error_string(err).decode()}")
    rq_tokenize.launches += 1
    return RqTokenizeOutput(ids, emb, res, loss)


rq_tokenize.launches = 0
