"""Fused masked attention with a hand-written backward (counterpart of
rqvae_tpu/ops/flash_attention.py:flash_attention).

``flash_attention(q, k, v, *, k_mask=None, causal=False)`` on (B, H, N, Dh)
operands is an ``autograd.Function``: its forward runs ``flash_attention_fwd``
and its backward ``flash_attention_bwd``. Each wrapper launches its
hand-written CUDA kernel (``csrc/flash_attention_fwd.cu``,
``csrc/flash_attention_bwd.cu``) for CUDA tensors and runs the plain PyTorch
twin for CPU tensors; any other device raises, and there is no fallback from
one to the other. ``flash_attention_fwd.launches`` and
``flash_attention_bwd.launches`` count kernel launches (one backward launch
runs the dq kernel and the dk / dv kernel).

The twins carry the TPU kernel's own arithmetic: the key mask as an additive
fp32 bias (0 / -1e30), scores in fp32, the unnormalised ``e = exp(s - m)``
cast to the operand type before the PV product, and ``inv = where(m > -5e29,
1 / sum(e), 0)`` folded into the output, so a row with no valid key gives
zeros. The backward takes ``c = rowsum(dp * e) * inv`` and ``ds = e * ((dp -
c) * inv)``, accumulates in fp32 and casts dq, dk, dv to the operand types.

The kernels read strided operands: any (B, H, N, Dh) view whose last
dimension is contiguous, such as the transformer's q / k / v slices of one
fused qkv product seen through ``transpose(1, 2)``. Outputs are allocated in
the (B, N, H, Dh) layout and returned as (B, H, N, Dh) views, so the caller's
``merge_heads`` is a reshape without a copy.

The TPU kernel's ``block_q`` is a detail of its VMEM tiling and is not an
argument here: the CUDA kernels tile 64 rows x 64 keys. For bf16 operands
with Dh = 64 whose rows are 16-byte aligned (the model's case) the kernels
run on the tensor cores (mma.sync); fp32 operands, other head sizes up to
128 and unaligned views run an fp32 CUDA-core variant of the same function.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def mask_bias(k_mask: Optional[torch.Tensor], b: int, nk: int, device) -> torch.Tensor:
    """(B, Nk) additive fp32 bias: 0 where a key is valid, -1e30 where not."""
    if k_mask is None:
        return torch.zeros((b, nk), dtype=torch.float32, device=device)
    return torch.where(k_mask, 0.0, NEG_INF).to(torch.float32).reshape(b, nk)


def _scores(q, k, bias, causal):
    """fp32 scores with the mask, the row max m, e = exp(s - m), and inv."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale + bias[:, None, None, :]
    if causal:
        nq, nk = s.shape[-2:]
        keep = torch.arange(nk, device=s.device)[None, :] <= torch.arange(nq, device=s.device)[:, None]
        s = torch.where(keep, s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    e = torch.exp(s - m)                          # all-invalid rows: e == 1
    inv = torch.where(m > 0.5 * NEG_INF, 1.0 / torch.sum(e, dim=-1, keepdim=True), 0.0)
    return scale, m, e, inv


def _plain_fwd(q, k, v, bias, causal):
    _, m, e, inv = _scores(q, k, bias, causal)
    out = torch.matmul(e.to(v.dtype).float(), v.float()) * inv
    return out.to(q.dtype), m[..., 0], inv[..., 0]


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          k_mask: Optional[torch.Tensor] = None,
                          causal: bool = False) -> torch.Tensor:
    """Plain PyTorch twin of the forward kernel on (B, H, N, Dh) operands."""
    bias = mask_bias(k_mask, q.shape[0], k.shape[2], q.device)
    return _plain_fwd(q, k, v, bias, causal)[0]


def _plain_bwd(q, k, v, bias, g, causal):
    scale, _, e, inv = _scores(q, k, bias, causal)
    dp = torch.matmul(g.float(), v.float().transpose(-1, -2))
    c = torch.sum(dp * e, dim=-1, keepdim=True) * inv
    ds = (e * ((dp - c) * inv)).to(k.dtype).float()
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    g_n = (g.float() * inv).to(g.dtype).float()
    dv = torch.matmul(e.to(g.dtype).float().transpose(-1, -2), g_n)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                              *, k_mask: Optional[torch.Tensor] = None,
                              causal: bool = False):
    """Plain PyTorch twin of the backward kernel: (dq, dk, dv) for the
    upstream gradient ``g`` of the forward's output."""
    bias = mask_bias(k_mask, q.shape[0], k.shape[2], q.device)
    return _plain_bwd(q, k, v, bias, g, causal)


def _lib(name: str) -> ctypes.CDLL:
    from rqvae_tpu_torch.ops import _cuda_build

    lib = _cuda_build.load(name)
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if name == "flash_attention_fwd":
            lib.flash_fwd_launch.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, i, i, i, f, i, p]
            lib.flash_fwd_launch.restype = i
            lib.flash_fwd_error_string.argtypes = [i]
            lib.flash_fwd_error_string.restype = ctypes.c_char_p
        else:
            lib.flash_bwd_launch.argtypes = [i, p, p, p, p, p, p, p, p, p, p, p, p,
                                             i, i, i, i, i, i, f, i, p]
            lib.flash_bwd_launch.restype = i
            lib.flash_bwd_error_string.argtypes = [i]
            lib.flash_bwd_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_operands(q, k, v, extra=()):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash attention takes (B, H, N, Dh) operands, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, _, dh = q.shape
    if k.shape[:2] != (b, h) or k.shape[3] != dh or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    tensors = (q, k, v) + tuple(extra)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {devices}")
    dev = q.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cuda (kernel) or cpu (plain), got {dev}")
    return dev


def _check_kernel_operands(tensors, names):
    dtype = tensors[0].dtype
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"the flash kernels take float32 or bfloat16, got {dtype}")
    for t, name in zip(tensors, names):
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {dtype}: the kernels take one dtype")
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name} has head-dimension stride {t.stride(-1)}: the kernels need "
                             "it contiguous (stride 1)")
    b, h, nq, dh = tensors[0].shape
    nk = tensors[1].shape[2]
    if nq == 0 or nk == 0:
        raise ValueError(f"empty attention: Nq {nq}, Nk {nk}")
    if dh > 128:
        raise ValueError(f"the flash kernels take Dh <= 128, got {dh}")


def _bnhd_empty(b, h, n, dh, like):
    """An uninitialised (B, H, N, Dh) view of (B, N, H, Dh) storage."""
    return torch.empty((b, n, h, dh), dtype=like.dtype, device=like.device).transpose(1, 2)


def _strides(*tensors):
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _device_index(t) -> int:
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        k_mask: Optional[torch.Tensor] = None, causal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(out, m, inv): the attention output (B, H, Nq, Dh) in q's dtype and
    the row statistics the backward reads, each (B, H, Nq) fp32."""
    dev = _check_operands(q, k, v)
    b, h, nq, dh = q.shape
    nk = k.shape[2]
    bias = mask_bias(k_mask, b, nk, dev)
    if dev.type == "cpu":
        return _plain_fwd(q, k, v, bias, causal)
    _check_kernel_operands((q, k, v), ("q", "k", "v"))
    out = _bnhd_empty(b, h, nq, dh, q)
    m = torch.empty((b, h, nq), dtype=torch.float32, device=dev)
    inv = torch.empty_like(m)
    lib = _lib("flash_attention_fwd")
    err = lib.flash_fwd_launch(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        out.data_ptr(), m.data_ptr(), inv.data_ptr(), _strides(q, k, v, out),
        b, h, nq, nk, dh, int(causal), 1.0 / math.sqrt(dh), _device_index(q),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: "
                           f"{lib.flash_fwd_error_string(err).decode()}")
    flash_attention_fwd.launches += 1
    return out, m, inv


flash_attention_fwd.launches = 0


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                        m: torch.Tensor, inv: torch.Tensor, *,
                        k_mask: Optional[torch.Tensor] = None, causal: bool = False):
    """(dq, dk, dv) for the upstream gradient ``g`` (B, H, Nq, Dh), given the
    forward's row statistics ``m`` and ``inv`` (the CPU twin recomputes
    them)."""
    dev = _check_operands(q, k, v, (g, m, inv))
    b, h, nq, dh = q.shape
    nk = k.shape[2]
    if g.shape != q.shape or m.shape != (b, h, nq) or inv.shape != (b, h, nq):
        raise ValueError(f"g {tuple(g.shape)}, m {tuple(m.shape)}, inv {tuple(inv.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    bias = mask_bias(k_mask, b, nk, dev)
    if dev.type == "cpu":
        return _plain_bwd(q, k, v, bias, g, causal)
    _check_kernel_operands((q, k, v, g), ("q", "k", "v", "g"))
    m = m.to(torch.float32).contiguous()
    inv = inv.to(torch.float32).contiguous()
    c = torch.empty_like(m)
    dq = _bnhd_empty(b, h, nq, dh, q)
    dk = _bnhd_empty(b, h, nk, dh, k)
    dv = _bnhd_empty(b, h, nk, dh, v)
    lib = _lib("flash_attention_bwd")
    err = lib.flash_bwd_launch(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        g.data_ptr(), m.data_ptr(), inv.data_ptr(), c.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), _strides(q, k, v, g, dq, dk, dv), b, h, nq, nk, dh, int(causal),
        1.0 / math.sqrt(dh), _device_index(q), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: "
                           f"{lib.flash_bwd_error_string(err).decode()}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, k_mask, causal):
        out, m, inv = flash_attention_fwd(q, k, v, k_mask=k_mask, causal=causal)
        ctx.save_for_backward(q, k, v, k_mask, m, inv)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, k_mask, m, inv = ctx.saved_tensors
        if g.stride(-1) != 1:
            g = g.contiguous()  # autograd may hand over any layout; one copy then
        dq, dk, dv = flash_attention_bwd(q, k, v, g, m, inv, k_mask=k_mask, causal=ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    k_mask: Optional[torch.Tensor] = None,
                    causal: bool = False) -> torch.Tensor:
    """Fused masked attention over (B, H, N, Dh) operands; differentiable.
    ``k_mask`` (B, Nk) bool, True = attend; None = every key valid."""
    _check_operands(q, k, v)
    return _FlashAttention.apply(q, k, v, k_mask, bool(causal))
