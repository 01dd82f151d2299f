"""Fused masked attention with a hand-written backward (counterpart of
rqvae_tpu/ops/flash_attention.py: flash_attention, flash_attention_spans and
flash_attention_small).

``flash_attention(q, k, v, *, k_mask=None, causal=False)`` on (B, H, N, Dh)
operands is an ``autograd.Function``: its forward runs ``flash_attention_fwd``
and its backward ``flash_attention_bwd``. Each wrapper launches its
hand-written CUDA kernel (``csrc/flash_attention_fwd.cu``,
``csrc/flash_attention_bwd.cu``) for CUDA tensors and runs the plain PyTorch
twin for CPU tensors; any other device raises, and there is no fallback from
one to the other. ``flash_attention_fwd.launches`` and
``flash_attention_bwd.launches`` count kernel launches (one backward launch
runs the backward's kernels, see ``csrc/flash_attention_bwd.cuh``).

``flash_attention_spans(q, k, v, lo, hi, extra)`` is the packed-training
variant, built the same way (``flash_attention_spans_fwd`` /
``flash_attention_spans_bwd`` over ``csrc/flash_attention_spans_fwd.cu`` /
``csrc/flash_attention_spans_bwd.cu``, each with a ``.launches`` count, and
the twins ``flash_attention_spans_plain`` / ``flash_attention_spans_bwd_plain``):
query i attends keys [lo_i, hi_i) and key extra_i (``span_mask``), the
bounds (B, Nq) ints. Its mask is a select after scaling, not a bias, as in
the TPU kernel. All four kernels share their tile loops
(``csrc/flash_attention_{fwd,bwd}.cuh``) and differ in the mask policy.

``flash_attention_small(q, k, v, *, k_mask=None, causal=False)`` is the
short-sequence variant (counterpart of flash_attention_small; Nq, Nk <= 255,
the shapes ``attend``'s short route sends): the same function and arguments
as ``flash_attention``, over ``flash_attention_small_fwd`` /
``flash_attention_small_bwd`` (``csrc/flash_attention_small_fwd.cu`` /
``csrc/flash_attention_small_bwd.cu``, each with a ``.launches`` count). A
CTA stages whole (batch, head) pairs, takes one softmax over each query's
whole row (no online carry, the TPU kernel's order) and the backward is one
kernel that writes dq, dk and dv with no atomics. At Dh = 64 with 16-byte
aligned rows they run on the tensor cores (``small_route`` restates the
libraries' gates; each short wrapper counts its launches by route in
``route_launches``): bf16 on mma.sync, fp32 (every shipped decoder config)
as three TF32 mma.sync products a product over the live key tiles only.
The bf16 backward is one of three kernels (``small_bwd_route``; its
launches by kernel in ``bf16_launches``): a warp a pair at Nq <= 16 and Nk
<= 96, a CTA a pair at a time up to 96 keys, and the strips route for Nk >
96 or Nq > 208 (ML-32M's short bucket), which copies and computes only the
live key tiles, a CTA a pair: four warps split the live tiles at Nq <= 16,
else a warp a query tile takes strips of four live tiles through a
cp.async ring. Its bytes (0.115 ms at 241 x 241, B = 256, H = 8,
on an H100) are not what bounds it: every mma.sync product reads its
fragments from shared memory, so the design reads each operand there as
few times as its registers allow.
The TPU short kernel computes the flat kernel's algebra bit for bit, so its twins
``flash_attention_small_plain`` / ``flash_attention_small_bwd_plain`` are the
flat twins' arithmetic.

The twins carry the TPU kernels' own arithmetic: scores in fp32 with the
mask (flash_attention: the key mask as an additive fp32 bias 0 / -1e30, then
the causal cut; spans: ``where(allow, s, -1e30)``), the unnormalised
``e = exp(s - m)`` cast to the operand type before the PV product, and
``inv = where(m > -5e29, 1 / sum(e), 0)`` folded into the output, so a row
with no allowed key gives zeros. The backward takes ``c = rowsum(dp * e) *
inv`` and ``ds = e * ((dp - c) * inv)`` cast to the operand type, ``g * inv``
cast to g's type for dv, accumulates in fp32 and casts dq, dk, dv to the
operand types.

The kernels read strided operands: any (B, H, N, Dh) view whose last
dimension is contiguous, such as the transformer's q / k / v slices of one
fused qkv product seen through ``transpose(1, 2)``. Outputs are allocated in
the (B, N, H, Dh) layout and returned as (B, H, N, Dh) views, so the caller's
``merge_heads`` is a reshape without a copy.

The TPU kernel's ``block_q`` is a detail of its VMEM tiling and is not an
argument here: the CUDA kernels tile 64 rows x 64 keys. At Dh = 64 with
16-byte aligned rows (the model's case) the flat and span kernels run on the
tensor cores (``kernel_route``; each wrapper counts its launches by route in
``route_launches``): bf16 on wgmma, the forward with two 64-row warpgroups
a block sharing each key tile and its softmax in log2 units (exp2 of one
FMA, m converted back to natural units once), the backward adding dq into a
(B, H, Nq, 64) fp32 accumulator with atomics; fp32 (every shipped MovieLens
decoder config trains in fp32) as three TF32 products a product (each
operand split into a TF32 big and small half, the small x small term
dropped), the forward on wgmma, the backward on mma.sync adding dq into its
output with atomics. Either backward's fp32 sum order for dq varies from
run to run. Other head sizes up to 128 and unaligned views run a CUDA-core
variant of the same function. The kernels take no Dh above ``MAX_DH`` and
raise on it; ``attend`` routes such heads to its dense path. The span
kernels skip every (query tile, key tile) pair in which no row may attend
any key, the tensor-core flat forwards every key tile whose keys are all
masked and the fp32 flat backward every pair of such keys or past the
causal cut; that adds exactly
nothing to the sums (a fully masked row still gives zeros, m = -1e30 and
inv = 0), so only the order of the fp32 sums differs from the twin's.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from rqvae_tpu_torch.utils import profiling

NEG_INF = -1e30
MAX_DH = 128   # the widest head the CUDA kernels stage (csrc/flash_attention_common.cuh: dp_for)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def mask_bias(k_mask: Optional[torch.Tensor], b: int, nk: int, device) -> torch.Tensor:
    """(B, Nk) additive fp32 bias: 0 where a key is valid, -1e30 where not."""
    if k_mask is None:
        return torch.zeros((b, nk), dtype=torch.float32, device=device)
    return torch.where(k_mask, 0.0, NEG_INF).to(torch.float32).reshape(b, nk)


def _key_masker(bias, causal):
    """flash_attention's mask: the fp32 key bias added to the scaled scores,
    then the causal cut as a select."""
    def apply(s):
        s = s + bias[:, None, None, :]
        if causal:
            nq, nk = s.shape[-2:]
            keep = torch.arange(nk, device=s.device)[None, :] <= torch.arange(nq, device=s.device)[:, None]
            s = torch.where(keep, s, NEG_INF)
        return s

    return apply


def span_mask(q_spans, k_len: int) -> torch.Tensor:
    """Per-query contiguous key window plus one extra column:
    ``q_spans = (lo, hi, extra)``, each (B, Nq) int; query i may attend key
    j iff ``lo[i] <= j < hi[i]`` or ``j == extra[i]`` (extra = -1 for none;
    lo = hi = 0 attends nothing). Returns (B, Nq, Nk) bool."""
    lo, hi, extra = q_spans
    cols = torch.arange(k_len, device=lo.device)[None, None, :]
    return ((cols >= lo[..., None]) & (cols < hi[..., None])) | (cols == extra[..., None])


def _span_masker(lo, hi, extra):
    """flash_attention_spans' mask: a select after scaling, no bias."""
    def apply(s):
        return torch.where(span_mask((lo, hi, extra), s.shape[-1])[:, None], s, NEG_INF)

    return apply


def _scores(q, k, masker):
    """fp32 scores with the mask, the row max m, e = exp(s - m), and inv."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = masker(torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale)
    m = torch.amax(s, dim=-1, keepdim=True)
    e = torch.exp(s - m)                          # all-masked rows: e == 1
    inv = torch.where(m > 0.5 * NEG_INF, 1.0 / torch.sum(e, dim=-1, keepdim=True), 0.0)
    return scale, m, e, inv


def _plain_fwd(q, k, v, masker):
    _, m, e, inv = _scores(q, k, masker)
    out = torch.matmul(e.to(v.dtype).float(), v.float()) * inv
    return out.to(q.dtype), m[..., 0], inv[..., 0]


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          k_mask: Optional[torch.Tensor] = None,
                          causal: bool = False) -> torch.Tensor:
    """Plain PyTorch twin of the forward kernel on (B, H, N, Dh) operands."""
    bias = mask_bias(k_mask, q.shape[0], k.shape[2], q.device)
    return _plain_fwd(q, k, v, _key_masker(bias, causal))[0]


def _plain_bwd(q, k, v, g, masker):
    scale, _, e, inv = _scores(q, k, masker)
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
    return _plain_bwd(q, k, v, g, _key_masker(bias, causal))


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# wrapper name -> (the C prefix of csrc/<name>.cu's functions, its launch argtypes)
_C_FUNCTIONS = {
    "flash_attention_fwd": ("flash_fwd", [_I] + [_P] * 8 + [_I] * 6 + [_F, _I, _P]),
    "flash_attention_bwd": ("flash_bwd", [_I] + [_P] * 13 + [_I] * 6 + [_F, _I, _P]),
    "flash_attention_spans_fwd": ("flash_spans_fwd", [_I] + [_P] * 10 + [_I] * 5 + [_F, _I, _P]),
    "flash_attention_spans_bwd": ("flash_spans_bwd", [_I] + [_P] * 15 + [_I] * 5 + [_F, _I, _P]),
    "flash_attention_small_fwd": ("flash_small_fwd", [_I] + [_P] * 8 + [_I] * 6 + [_F, _I, _P]),
    "flash_attention_small_bwd": ("flash_small_bwd", [_I] + [_P] * 11 + [_I] * 6 + [_F, _I, _P]),
}


def _c_function(wrapper, suffix: str):
    """``<prefix>_<suffix>`` of ``csrc/<wrapper.__name__>.cu``'s library
    (built at first use)."""
    from rqvae_tpu_torch.ops import _cuda_build

    name = wrapper.__name__
    return getattr(_cuda_build.load(name), f"{_C_FUNCTIONS[name][0]}_{suffix}")


def _launch(wrapper, *args, route: Optional[str] = None) -> None:
    """Launch the kernel(s) of ``csrc/<wrapper.__name__>.cu`` with ``args``
    (built at first use), raise on the CUDA error code it returns, and count
    the launch on ``wrapper.launches`` and, when the caller names the route
    the library's gate gave these operands, on
    ``wrapper.route_launches[route]``."""
    name = wrapper.__name__
    argtypes = _C_FUNCTIONS[name][1]
    launch, error = _c_function(wrapper, "launch"), _c_function(wrapper, "error_string")
    if launch.argtypes is None:
        launch.argtypes, launch.restype = argtypes, ctypes.c_int
        error.argtypes, error.restype = [ctypes.c_int], ctypes.c_char_p
    err = launch(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {error(err).decode()}")
    wrapper.launches += 1
    if route is not None:
        wrapper.route_launches[route] += 1


# The kernels a flat or span wrapper's call takes, as the C dispatchers gate
# them (csrc/flash_attention_common.cuh: Route): fp32 or bf16 FMAs on the
# CUDA cores, bf16 on wgmma (Dh = 64), fp32 as three TF32 products (Dh = 64).
ROUTES = ("cuda_cores", "wgmma_bf16", "tf32x3")


def kernel_route(wrapper, q, k, v, x) -> str:
    """The route (``ROUTES``) of ``csrc/<wrapper.__name__>.cu`` for these
    (B, H, N, Dh) operands at these addresses and strides, as its dispatcher
    decides it; ``x`` is the output o of a forward, the gradient g of a
    backward (built at first use)."""
    fn = _c_function(wrapper, "route")
    if fn.argtypes is None:
        fn.argtypes, fn.restype = [_I] + [_P] * 5 + [_I], ctypes.c_int
    return ROUTES[fn(_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), x.data_ptr(),
                     _strides(q, k, v, x), q.shape[-1])]


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
    if dh > MAX_DH:
        raise ValueError(f"the flash kernels take Dh <= {MAX_DH}, got {dh}")


def _bnhd_empty(b, h, n, dh, like):
    """An uninitialised (B, H, N, Dh) view of (B, N, H, Dh) storage."""
    return torch.empty((b, n, h, dh), dtype=like.dtype, device=like.device).transpose(1, 2)


def _strides(*tensors):
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _device_index(t) -> int:
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


def _check_bwd_operands(q, g, m, inv):
    b, h, nq, _ = q.shape
    if g.shape != q.shape or m.shape != (b, h, nq) or inv.shape != (b, h, nq):
        raise ValueError(f"g {tuple(g.shape)}, m {tuple(m.shape)}, inv {tuple(inv.shape)} do not "
                         f"fit q {tuple(q.shape)}")


def _bwd_scratch(wrapper, q, k, v, g, m):
    """The flat and span backward kernels' scratch and route: (c, acc,
    route) with c (B, H, Nq) fp32 and, where the C dispatcher takes bf16 on
    wgmma for these operands (``kernel_route``, the one place that rule
    lives), the (B, H, Nq, 64) fp32 dq accumulator that its c kernel zeroes,
    else None (the fp32 TF32 route adds into dq itself). Allocated before
    the gradients, so that the caching allocator hands each backward call
    the blocks the previous one freed."""
    route = kernel_route(wrapper, q, k, v, g)
    acc = None
    if route == "wgmma_bf16":
        acc = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    return torch.empty_like(m), acc, route


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def attribute_calls(wrapper) -> int:
    """How many ``cudaFuncSetAttribute`` calls the kernel library of
    ``wrapper`` has made in this process (each library raises its kernels'
    shared-memory opt-in once, csrc/flash_attention_common.cuh)."""
    fn = _c_function(wrapper, "attribute_calls")
    fn.argtypes, fn.restype = [], ctypes.c_longlong
    return int(fn())


def _bias_fwd(wrapper, q, k, v, bias, causal):
    """The body of the key-bias forward wrappers (``flash_attention_fwd``,
    ``flash_attention_small_fwd``: one C signature), given the (B, Nk) key
    bias of ``mask_bias``."""
    dev = q.device
    b, h, nq, dh = q.shape
    nk = k.shape[2]
    if dev.type == "cpu":
        return _plain_fwd(q, k, v, _key_masker(bias, causal))
    _check_kernel_operands((q, k, v), ("q", "k", "v"))
    out = _bnhd_empty(b, h, nq, dh, q)
    m = torch.empty((b, h, nq), dtype=torch.float32, device=dev)
    inv = torch.empty_like(m)
    route = (small_fwd_kernel_route(q, k, v, out) if wrapper is flash_attention_small_fwd
             else kernel_route(wrapper, q, k, v, out))
    _launch(wrapper, _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr(), out.data_ptr(), m.data_ptr(), inv.data_ptr(), _strides(q, k, v, out),
            b, h, nq, nk, dh, int(causal), 1.0 / math.sqrt(dh), _device_index(q),
            torch.cuda.current_stream(dev).cuda_stream, route=route)
    return out, m, inv


def _bias_bwd(wrapper, q, k, v, g, m, inv, bias, causal):
    """The body of the key-bias backward wrappers (``flash_attention_bwd``,
    whose kernels take the scratch of ``_bwd_scratch``, and
    ``flash_attention_small_bwd``, one kernel, none), given the forward's
    (B, Nk) key bias."""
    dev = q.device
    b, h, nq, dh = q.shape
    nk = k.shape[2]
    if dev.type == "cpu":
        return _plain_bwd(q, k, v, g, _key_masker(bias, causal))
    _check_kernel_operands((q, k, v, g), ("q", "k", "v", "g"))
    m = m.to(torch.float32).contiguous()
    inv = inv.to(torch.float32).contiguous()
    scratch = ()
    if wrapper is not flash_attention_small_bwd:
        *scratch, route = _bwd_scratch(wrapper, q, k, v, g, m)
    dq = _bnhd_empty(b, h, nq, dh, q)
    dk = _bnhd_empty(b, h, nk, dh, k)
    dv = _bnhd_empty(b, h, nk, dh, v)
    if wrapper is flash_attention_small_bwd:
        route = small_bwd_kernel_gate(q, k, v, g, dq, dk, dv)
    _launch(wrapper, _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr(), g.data_ptr(), m.data_ptr(), inv.data_ptr(), *map(_ptr, scratch),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _strides(q, k, v, g, dq, dk, dv), b, h, nq,
            nk, dh, int(causal), 1.0 / math.sqrt(dh), _device_index(q),
            torch.cuda.current_stream(dev).cuda_stream, route=route)
    if wrapper is flash_attention_small_bwd and route == "mma_bf16":
        wrapper.bf16_launches[small_bwd_route(nq, nk)] += 1
    return dq, dk, dv


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        k_mask: Optional[torch.Tensor] = None, causal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(out, m, inv): the attention output (B, H, Nq, Dh) in q's dtype and
    the row statistics the backward reads, each (B, H, Nq) fp32."""
    _check_operands(q, k, v)
    return _bias_fwd(flash_attention_fwd, q, k, v, mask_bias(k_mask, q.shape[0], k.shape[2], q.device),
                     causal)


flash_attention_fwd.launches = 0
flash_attention_fwd.route_launches = dict.fromkeys(ROUTES, 0)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                        m: torch.Tensor, inv: torch.Tensor, *,
                        k_mask: Optional[torch.Tensor] = None, causal: bool = False):
    """(dq, dk, dv) for the upstream gradient ``g`` (B, H, Nq, Dh), given the
    forward's row statistics ``m`` and ``inv`` (the CPU twin recomputes
    them)."""
    _check_operands(q, k, v, (g, m, inv))
    _check_bwd_operands(q, g, m, inv)
    return _bias_bwd(flash_attention_bwd, q, k, v, g, m, inv,
                     mask_bias(k_mask, q.shape[0], k.shape[2], q.device), causal)


flash_attention_bwd.launches = 0
flash_attention_bwd.route_launches = dict.fromkeys(ROUTES, 0)


def attention_span(name: str, family: str, b: int, h: int, nq: int, nk: int, dh: int,
                   dtype: torch.dtype, causal: bool):
    """The ``utils/profiling`` span of one attention call (``attn.fwd`` /
    ``attn.bwd``) with its route family and shapes."""
    return profiling.span(name, family=family, B=b, H=h, Nq=nq, Nk=nk, Dh=dh,
                          dtype=str(dtype).removeprefix("torch."), causal=bool(causal))


class _FlashAttention(torch.autograd.Function):
    """flash_attention (``small`` False) or flash_attention_small (True):
    the same function and saved statistics, other kernels. The operands are
    checked by the caller; the key bias is built once, in the forward, and
    saved for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, k_mask, causal, small):
        fwd = flash_attention_small_fwd if small else flash_attention_fwd
        bias = mask_bias(k_mask, q.shape[0], k.shape[2], q.device)
        out, m, inv = _bias_fwd(fwd, q, k, v, bias, causal)
        ctx.save_for_backward(q, k, v, bias, m, inv)
        ctx.causal, ctx.small = causal, small
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, m, inv = ctx.saved_tensors
        with (attention_span("attn.bwd", "small" if ctx.small else "flat", *q.shape[:3],
                             k.shape[2], q.shape[3], q.dtype, ctx.causal)
              if profiling.enabled() else profiling.OFF):
            if g.stride(-1) != 1:
                g = g.contiguous()  # autograd may hand over any layout; one copy then
            bwd = flash_attention_small_bwd if ctx.small else flash_attention_bwd
            dq, dk, dv = _bias_bwd(bwd, q, k, v, g, m, inv, bias, ctx.causal)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    k_mask: Optional[torch.Tensor] = None,
                    causal: bool = False) -> torch.Tensor:
    """Fused masked attention over (B, H, N, Dh) operands; differentiable.
    ``k_mask`` (B, Nk) bool, True = attend; None = every key valid."""
    _check_operands(q, k, v)
    return _FlashAttention.apply(q, k, v, k_mask, bool(causal), False)


# ---------------------------------------------------------------------------
# Short-sequence variant (flash_attention_small): Nq, Nk < 256, each query's
# whole score row at once
# ---------------------------------------------------------------------------

SMALL_MAX_LEN = 255   # attend's short route sends Nq, Nk < 256

# The kernel family a short call takes, as the libraries' gates decide it
# (csrc/flash_attention_small.cuh: Route): fp32 or bf16 FMAs on the CUDA
# cores, bf16 on mma.sync (Dh = 64), fp32 as three TF32 products on
# mma.sync (Dh = 64). Each short wrapper counts its launches by route in
# ``route_launches``.
SMALL_ROUTES = ("cuda_cores", "mma_bf16", "tf32x3")
# The bf16 Dh = 64 backward kernels (``small_bwd_route``)
SMALL_BWD_ROUTES = ("rows", "tiles", "strips")


# The TPU short kernel computes the flat kernel's algebra bit for bit (one
# softmax over the whole row is what the flat twin takes: the key bias, the
# causal cut cols <= rows, e cast before PV), so the short twins are the flat
# twins.
flash_attention_small_plain = flash_attention_plain
flash_attention_small_bwd_plain = flash_attention_bwd_plain


def _check_small(q, k):
    nq, nk = q.shape[2], k.shape[2]
    if nq > SMALL_MAX_LEN or nk > SMALL_MAX_LEN:
        raise ValueError(f"flash_attention_small takes Nq, Nk <= {SMALL_MAX_LEN} (attend's "
                         f"short route), got Nq {nq}, Nk {nk}")


def flash_attention_small_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                              k_mask: Optional[torch.Tensor] = None, causal: bool = False
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(out, m, inv) of short attention, as ``flash_attention_fwd`` returns
    them, from ``csrc/flash_attention_small_fwd.cu``."""
    _check_operands(q, k, v)
    _check_small(q, k)
    return _bias_fwd(flash_attention_small_fwd, q, k, v,
                     mask_bias(k_mask, q.shape[0], k.shape[2], q.device), causal)


flash_attention_small_fwd.launches = 0
flash_attention_small_fwd.route_launches = dict.fromkeys(SMALL_ROUTES, 0)


def flash_attention_small_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                              m: torch.Tensor, inv: torch.Tensor, *,
                              k_mask: Optional[torch.Tensor] = None, causal: bool = False):
    """(dq, dk, dv) of short attention for the upstream gradient ``g``,
    given the forward's row statistics (the CPU twin recomputes them), from
    the one-shot kernel ``csrc/flash_attention_small_bwd.cu``."""
    _check_operands(q, k, v, (g, m, inv))
    _check_bwd_operands(q, g, m, inv)
    _check_small(q, k)
    return _bias_bwd(flash_attention_small_bwd, q, k, v, g, m, inv,
                     mask_bias(k_mask, q.shape[0], k.shape[2], q.device), causal)


flash_attention_small_bwd.launches = 0
flash_attention_small_bwd.route_launches = dict.fromkeys(SMALL_ROUTES, 0)
# the bf16 launches (route "mma_bf16") by kernel: a warp a pair, a CTA a
# pair at a time, the strips route (``small_bwd_route``)
flash_attention_small_bwd.bf16_launches = dict.fromkeys(SMALL_BWD_ROUTES, 0)


SMALL_ONE_CTA_SMEM = 232448   # the shared memory a CTA may take (csrc/flash_attention_small.cuh)


def small_bwd_strips_smem(nq: int, nk: int) -> int:
    """Shared memory a CTA of the bf16 strips route takes at (Nq, Nk),
    restated from ``csrc/flash_attention_small_bwd.cu`` (``kKeysSmem``,
    ``strips_smem_bytes``): at Nq <= 16 the keys mode's one size (q, g
    [16][64] and K, V for all 16 key tiles in bf16; m, inv, four warps' c
    partials and the key bias in fp32), else the strips mode's q, g [nqp][64]
    bf16 and m, inv fp32, the key bias, a three-stage ring of four live
    tiles' K and V, and one strip's bf16 e and ds [nqp][72].
    ``chip_smoke.py`` holds it against the library's
    ``small_bwd_strips_plan``."""
    nqp, nkp = 16 * -(-nq // 16), 16 * -(-nk // 16)
    if nqp == 16:
        return (2 * 16 + 2 * 16 * 16) * 64 * 2 + (2 + 4 + 16) * 16 * 4
    return nqp * (2 * 64 * 2 + 8) + 4 * nkp + 3 * 2 * 4 * 16 * 64 * 2 + 2 * nqp * 72 * 2


def small_bwd_route(nq: int, nk: int) -> str:
    """The bf16 Dh = 64 kernel of ``csrc/flash_attention_small_bwd.cu`` that
    takes an (Nq, Nk) shape (``SMALL_BWD_ROUTES``: a warp a pair, a CTA a
    pair at a time, a CTA a pair over its live key tiles), restated from
    its dispatcher (``bwd_route``) for the CPU emulation of that kernel's
    arithmetic. ``chip_smoke.py`` holds it against the library's own answer,
    ``small_bwd_kernel_route``. The strips route takes every Nk > 96 and
    the Nk <= 96 shapes whose tiles-kernel stage exceeds a CTA's shared
    memory (Nq > 208)."""
    nqp, nkp = 16 * -(-nq // 16), 16 * -(-nk // 16)
    if nkp > 96:
        return "strips"
    if nqp == 16:
        return "rows"
    # two query sides (q, g, m, inv), one key side (k, v, key bias), bf16 e and ds
    smem = 2 * nqp * (4 * 64 + 8) + nkp * (4 * 64 + 4) + 2 * nqp * (nkp + 8) * 2
    return "tiles" if smem <= SMALL_ONE_CTA_SMEM else "strips"


def small_bwd_kernel_route(nq: int, nk: int) -> str:
    """``small_bwd_route`` as the kernel library answers it (built at first
    use)."""
    fn = _c_function(flash_attention_small_bwd, "route")
    if fn.argtypes is None:
        fn.argtypes, fn.restype = [_I, _I], ctypes.c_int
    return SMALL_BWD_ROUTES[fn(nq, nk)]


def _aligned(t: torch.Tensor, elems: int) -> bool:
    """Whether a (B, H, N, Dh) view's base and (batch, head, seq) strides
    are multiples of ``elems`` elements (the base of ``elems`` elements'
    bytes)."""
    return (t.data_ptr() % (elems * t.element_size()) == 0
            and all(st % elems == 0 for st in t.stride()[:3]))


def small_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, x: torch.Tensor,
                outs: Tuple[torch.Tensor, ...] = ()) -> str:
    """The kernel family (``SMALL_ROUTES``) of the short kernels that takes
    these (B, H, N, Dh) operands: the forward's for ``x`` its output o, the
    backward's for ``x`` the upstream g and ``outs`` (dq, dk, dv). Restated
    from the libraries' gates (``fwd_gate`` / ``bwd_gate``) for the CPU
    tests; ``chip_smoke.py`` holds it against their own answers,
    ``small_fwd_kernel_route`` and ``small_bwd_kernel_gate``. At Dh = 64,
    fp32 takes the TF32 kernels when every operand has 16-byte aligned rows
    (float4 reads and stores); bf16 the mma.sync kernels when q, k, v and
    o / g have 16-byte aligned rows and dq, dk, dv 4-byte aligned pairs;
    anything else the CUDA-core kernels."""
    if q.shape[-1] != 64:
        return "cuda_cores"
    if q.dtype == torch.float32:
        ok = all(_aligned(t, 4) for t in (q, k, v, x) + tuple(outs))
        return "tf32x3" if ok else "cuda_cores"
    ok = all(_aligned(t, 8) for t in (q, k, v, x)) and all(_aligned(t, 2) for t in outs)
    return "mma_bf16" if ok else "cuda_cores"


def small_fwd_kernel_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           o: torch.Tensor) -> str:
    """The kernel family (``SMALL_ROUTES``) of
    ``csrc/flash_attention_small_fwd.cu`` that takes (B, H, N, Dh) operands
    of q's dtype at these addresses and strides, as the library's launcher
    gates it (built at first use): ``"mma_bf16"`` is
    ``small_fwd_live_kernel``, ``"tf32x3"`` ``small_fwd_tf32_kernel``."""
    fn = _c_function(flash_attention_small_fwd, "route")
    if fn.argtypes is None:
        fn.argtypes, fn.restype = [_I] + [_P] * 5 + [_I], ctypes.c_int
    return SMALL_ROUTES[fn(_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          o.data_ptr(), _strides(q, k, v, o), q.shape[-1])]


def small_bwd_kernel_gate(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                          dq: torch.Tensor, dk: torch.Tensor, dv: torch.Tensor) -> str:
    """The kernel family (``SMALL_ROUTES``) of
    ``csrc/flash_attention_small_bwd.cu`` that takes these operands and
    gradients, as the library's launcher gates it (built at first use);
    within ``"mma_bf16"``, ``small_bwd_kernel_route`` names the kernel."""
    fn = _c_function(flash_attention_small_bwd, "gate")
    if fn.argtypes is None:
        fn.argtypes, fn.restype = [_I] + [_P] * 8 + [_I], ctypes.c_int
    return SMALL_ROUTES[fn(_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                          _strides(q, k, v, g, dq, dk, dv), q.shape[-1])]


def small_bwd_tf32_plan(device: int = 0) -> dict:
    """The fp32 Dh = 64 backward kernel's launch (one for every shape), as
    the kernel library plans it (built at first use): warps and shared
    memory a CTA, CTAs an SM."""
    fn = _c_function(flash_attention_small_bwd, "tf32_plan")
    if fn.argtypes is None:
        fn.argtypes, fn.restype = [_I, _P], None
    out = (ctypes.c_longlong * 3)()
    fn(device, out)
    return dict(zip(("warps", "smem_bytes", "ctas_per_sm"), out))


def small_bwd_strips_plan(nq: int, nk: int, device: int = 0) -> dict:
    """The bf16 strips route's launch at (Nq, Nk), as the kernel library
    plans it (built at first use): warps and shared memory a CTA, CTAs an
    SM, and whether it is the keys mode (Nq <= 16); -1 everywhere for a
    shape on another route."""
    fn = _c_function(flash_attention_small_bwd, "strips_plan")
    if fn.argtypes is None:
        fn.argtypes, fn.restype = [_I, _I, _I, _P], None
    out = (ctypes.c_longlong * 4)()
    fn(nq, nk, device, out)
    return dict(zip(("warps", "smem_bytes", "ctas_per_sm", "keys_mode"), out))


def small_fwd_plan(bh: int, nq: int, nk: int, device: int = 0) -> dict:
    """The bf16 Dh = 64 forward kernel's launch for (B H, Nq, Nk), as the
    kernel library plans it (built at first use): pairs a unit, stages,
    warps and shared memory a CTA, CTAs an SM."""
    fn = _c_function(flash_attention_small_fwd, "plan")
    if fn.argtypes is None:
        fn.argtypes, fn.restype = [_I, _I, _I, _I, _P], None
    out = (ctypes.c_longlong * 5)()
    fn(bh, nq, nk, device, out)
    return dict(zip(("pairs_a_unit", "stages", "warps", "smem_bytes", "ctas_per_sm"), out))


def small_fwd_tf32_plan(nk: int, device: int = 0) -> dict:
    """The fp32 Dh = 64 forward kernel's launch at Nk keys, as the kernel
    library plans it (built at first use): warps and shared memory a CTA,
    CTAs an SM."""
    fn = _c_function(flash_attention_small_fwd, "tf32_plan")
    if fn.argtypes is None:
        fn.argtypes, fn.restype = [_I, _I, _P], None
    out = (ctypes.c_longlong * 3)()
    fn(nk, device, out)
    return dict(zip(("warps", "smem_bytes", "ctas_per_sm"), out))


def flash_attention_small(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          k_mask: Optional[torch.Tensor] = None,
                          causal: bool = False) -> torch.Tensor:
    """Short-sequence fused attention (Nq, Nk <= 255) over (B, H, N, Dh)
    operands; differentiable. Same arguments and function as
    ``flash_attention``."""
    _check_operands(q, k, v)
    _check_small(q, k)
    return _FlashAttention.apply(q, k, v, k_mask, bool(causal), True)


# ---------------------------------------------------------------------------
# Span-restricted variant (flash_attention_spans): per-query key window plus
# one extra column, the packed-training mask
# ---------------------------------------------------------------------------


def _span_operands(lo, hi, extra, b: int, nq: int):
    """The (B, Nq) bounds as contiguous int32, checked."""
    out = []
    for name, t in (("lo", lo), ("hi", hi), ("extra", extra)):
        if tuple(t.shape) != (b, nq):
            raise ValueError(f"{name} is {tuple(t.shape)}, expected (B, Nq) = {(b, nq)}")
        if t.dtype.is_floating_point or t.dtype == torch.bool:
            raise TypeError(f"{name} must be an integer tensor, got {t.dtype}")
        out.append(t.to(torch.int32).contiguous())
    return tuple(out)


def flash_attention_spans_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                lo: torch.Tensor, hi: torch.Tensor,
                                extra: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the span forward kernel on (B, H, N, Dh)
    operands and (B, Nq) bounds (``span_mask`` semantics)."""
    return _plain_fwd(q, k, v, _span_masker(lo, hi, extra))[0]


def flash_attention_spans_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                    lo: torch.Tensor, hi: torch.Tensor, extra: torch.Tensor,
                                    g: torch.Tensor):
    """Plain PyTorch twin of the span backward kernel: (dq, dk, dv) for the
    upstream gradient ``g``."""
    return _plain_bwd(q, k, v, g, _span_masker(lo, hi, extra))


def flash_attention_spans_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              lo: torch.Tensor, hi: torch.Tensor, extra: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(out, m, inv) of span-restricted attention: the output (B, H, Nq, Dh)
    in q's dtype and the row statistics the backward reads, (B, H, Nq) fp32."""
    dev = _check_operands(q, k, v, (lo, hi, extra))
    b, h, nq, dh = q.shape
    nk = k.shape[2]
    lo, hi, extra = _span_operands(lo, hi, extra, b, nq)
    if dev.type == "cpu":
        return _plain_fwd(q, k, v, _span_masker(lo, hi, extra))
    _check_kernel_operands((q, k, v), ("q", "k", "v"))
    out = _bnhd_empty(b, h, nq, dh, q)
    m = torch.empty((b, h, nq), dtype=torch.float32, device=dev)
    inv = torch.empty_like(m)
    _launch(flash_attention_spans_fwd, _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), lo.data_ptr(), hi.data_ptr(), extra.data_ptr(), out.data_ptr(),
            m.data_ptr(), inv.data_ptr(), _strides(q, k, v, out), b, h, nq, nk, dh,
            1.0 / math.sqrt(dh), _device_index(q), torch.cuda.current_stream(dev).cuda_stream,
            route=kernel_route(flash_attention_spans_fwd, q, k, v, out))
    return out, m, inv


flash_attention_spans_fwd.launches = 0
flash_attention_spans_fwd.route_launches = dict.fromkeys(ROUTES, 0)


def flash_attention_spans_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              lo: torch.Tensor, hi: torch.Tensor, extra: torch.Tensor,
                              g: torch.Tensor, m: torch.Tensor, inv: torch.Tensor):
    """(dq, dk, dv) of span-restricted attention for the upstream gradient
    ``g``, given the forward's row statistics (the CPU twin recomputes them)."""
    dev = _check_operands(q, k, v, (lo, hi, extra, g, m, inv))
    b, h, nq, dh = q.shape
    nk = k.shape[2]
    _check_bwd_operands(q, g, m, inv)
    lo, hi, extra = _span_operands(lo, hi, extra, b, nq)
    if dev.type == "cpu":
        return _plain_bwd(q, k, v, g, _span_masker(lo, hi, extra))
    _check_kernel_operands((q, k, v, g), ("q", "k", "v", "g"))
    m = m.to(torch.float32).contiguous()
    inv = inv.to(torch.float32).contiguous()
    c, acc, route = _bwd_scratch(flash_attention_spans_bwd, q, k, v, g, m)
    dq = _bnhd_empty(b, h, nq, dh, q)
    dk = _bnhd_empty(b, h, nk, dh, k)
    dv = _bnhd_empty(b, h, nk, dh, v)
    _launch(flash_attention_spans_bwd, _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), lo.data_ptr(), hi.data_ptr(), extra.data_ptr(), g.data_ptr(),
            m.data_ptr(), inv.data_ptr(), c.data_ptr(), _ptr(acc), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), _strides(q, k, v, g, dq, dk, dv), b, h, nq, nk, dh,
            1.0 / math.sqrt(dh), _device_index(q), torch.cuda.current_stream(dev).cuda_stream,
            route=route)
    return dq, dk, dv


flash_attention_spans_bwd.launches = 0
flash_attention_spans_bwd.route_launches = dict.fromkeys(ROUTES, 0)


class _FlashAttentionSpans(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, lo, hi, extra):
        out, m, inv = flash_attention_spans_fwd(q, k, v, lo, hi, extra)
        ctx.save_for_backward(q, k, v, lo, hi, extra, m, inv)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, lo, hi, extra, m, inv = ctx.saved_tensors
        with (attention_span("attn.bwd", "spans", *q.shape[:3], k.shape[2], q.shape[3], q.dtype,
                             False) if profiling.enabled() else profiling.OFF):
            if g.stride(-1) != 1:
                g = g.contiguous()  # autograd may hand over any layout; one copy then
            dq, dk, dv = flash_attention_spans_bwd(q, k, v, lo, hi, extra, g, m, inv)
        return dq, dk, dv, None, None, None


def flash_attention_spans(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lo: torch.Tensor, hi: torch.Tensor, extra: torch.Tensor) -> torch.Tensor:
    """Span-restricted fused attention over (B, H, N, Dh) operands;
    differentiable. ``lo``, ``hi``, ``extra`` are (B, Nq) ints: query i
    attends keys [lo_i, hi_i) and key extra_i (-1 = none). Non-causal; the
    packed decoder's causality within a segment is hi = own position + 1."""
    _check_operands(q, k, v, (lo, hi, extra))
    return _FlashAttentionSpans.apply(q, k, v, lo, hi, extra)
