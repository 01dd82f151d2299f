"""Fused residual-quantization kernels (counterpart of
rqvae_tpu/ops/quantize_pallas.py).

* ``rq_tokenize`` (eval / tokenize path) launches ``csrc/rq_tokenize.cu``
  for CUDA tensors and runs ``rq_tokenize_plain`` for CPU tensors.
* ``rq_quantize_train`` (stage-1 training path) is an autograd ``Function``:
  its forward launches ``csrc/rq_quantize_train.cu`` for CUDA tensors and
  runs ``rq_quantize_train_plain`` for CPU tensors; its backward is the JAX
  package's ``_rq_train_bwd`` in torch ops (plain jnp there too): the
  estimator-exact STE / rotation-trick gradients, levels in reverse.

There is no fallback from a kernel to its twin. Each call is one launch of
one of ``csrc/rq_common.cuh``'s two kernels (every level's codes resident in
each CTA, or split across a thread-block cluster), so any (L, K, D) stack
with D <= 128 runs; its note says what bounds them on an H100 and how they
are laid out. ``kernel_plan`` asks the library for the launch plan it
takes, on the card; ``plan`` restates that rule for the CPU tests' emulation
of the kernels (``chip_smoke.py`` holds the two equal).
``rq_tokenize.launches`` and ``rq_quantize_train.launches`` count kernel
launches.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

MAX_D = 128  # rq::kMaxD in csrc/rq_common.cuh
# the launch plan's constants (csrc/rq_common.cuh)
WARPS = 8
MAX_CLUSTER = 4
MAX_STAGES = 8
SLACK = 1024
H100_SMS = 132
H100_OPTIN = 232448   # opt-in shared memory a block, bytes
PLAN_FIELDS = ("resident", "rows", "cluster", "slice", "tile", "tiles", "stages", "swizzled",
               "smem", "grid")


def unit_codes(rows: int) -> int:
    """Codes of a warp's unit of ``rows`` rows (8 x 8 a lane)."""
    return 8 * (256 // rows)


def _fixed_smem(d: int, rows: int) -> int:
    return SLACK + 4 * (rows * d + rows + 2 * WARPS * rows + 4 * rows + rows
                        + WARPS * unit_codes(rows)) + 12 * MAX_STAGES


def _resident_smem(n_levels: int, k: int, d: int, rows: int) -> int:
    kp = -(-k // 64) * 64 if d % 32 == 0 else k
    return SLACK + 4 * (n_levels * kp * d + -(-(n_levels * kp) // 4) * 4 + rows * d) \
        + 8 * MAX_STAGES


def plan(b: int, n_levels: int, k: int, d: int, *, rows: int = 0, cluster: int = 0,
         sms: int = H100_SMS, optin: int = H100_OPTIN) -> dict:
    """The kernels' launch plan (``rq::plan_for`` / ``rq::plan_with``).
    ``resident``: every level's codes staged in each CTA (when they fit, at
    most 8 levels), ``rows`` (32 where that gives three quarters of the SMs
    a CTA, else 8) a CTA, no cluster. Else a cluster of ``cluster`` CTAs
    owns ``rows`` rows, each CTA a ``slice`` of every level's codes, staged
    ``tile`` codes a stage through ``stages`` stages (all of them at once
    when they fit); the largest grid in one wave (clusters of 4 on at most
    7/8 of the SMs), at least one unit of codes a CTA. Codes are copied in
    the 128-byte swizzle when D is a multiple of 32. The automatic plan on
    a device of ``sms`` SMs; ``rows`` and ``cluster`` set the cluster
    kernel's plan as a build with ``-DRQ_FORCE_ROWS`` / ``-DRQ_FORCE_CLUSTER``
    takes it, so that the emulation covers plans the rule picks only at
    large shapes."""
    if not rows and not cluster and n_levels <= MAX_STAGES \
            and _resident_smem(n_levels, k, d, 32) <= optin:
        r = 32 if -(-b // 32) >= (3 * sms) // 4 else 8
        return dict(resident=1, rows=r, cluster=1, slice=k,
                    tile=-(-k // 64) * 64 if d % 32 == 0 else k, tiles=1, stages=n_levels,
                    swizzled=int(d % 32 == 0), smem=_resident_smem(n_levels, k, d, r),
                    grid=-(-b // r))
    if not rows and not cluster:
        rows, cluster, best = 32, 1, 0
        for r in (32, 16):
            for c in (1, 2, 4):
                grid = -(-b // r) * c
                cap = (7 * sms) // 8 if c == 4 else sms
                if c > 1 and -(-k // c) < unit_codes(r):
                    continue
                if grid > cap or grid <= best:
                    continue
                rows, cluster, best = r, c, grid
    unit = unit_codes(rows)
    fixed = _fixed_smem(d, rows)
    budget, code_bytes = optin - fixed, 4 * d
    sl = -(-k // cluster)
    whole = -(-sl // unit) * unit
    if n_levels * whole * code_bytes <= budget:
        tile, tiles = whole, 1
    else:
        tmax = budget // (3 * code_bytes) // unit * unit
        tiles = -(-sl // tmax)
        tile = -(-(-(-sl // tiles)) // unit) * unit
    stages = min(n_levels * tiles, budget // (tile * code_bytes), MAX_STAGES)
    return dict(resident=0, rows=rows, cluster=cluster, slice=sl, tile=tile, tiles=tiles,
                stages=stages,
                swizzled=int(d % 32 == 0), smem=fixed + stages * tile * code_bytes,
                grid=-(-b // rows) * cluster)


class RqTokenizeOutput(NamedTuple):
    sem_ids: torch.Tensor   # (B, L) int32
    emb_sum: torch.Tensor   # (B, D) sum of selected codewords over levels
    residual: torch.Tensor  # (B, D) final residual (x - emb_sum)
    loss: torch.Tensor      # (B,) summed (1+beta)*||res_l - emb_l||^2


class RqTrainOutput(NamedTuple):
    embeddings: torch.Tensor     # (B, D, L) estimator outputs (== codewords)
    residuals: torch.Tensor      # (B, D, L) pre-level residuals (res_0 = x)
    sem_ids: torch.Tensor        # (B, L) int32
    quantize_loss: torch.Tensor  # (B,) summed (1+beta)*||res_l - emb_l||^2


def _plain_levels(x: torch.Tensor, codebooks: torch.Tensor, commitment_weight: float):
    """The kernels' arithmetic in torch ops, fp32: per level
    (||r||^2 - 2 r.cb) + ||cb||^2, argmin (first index on ties), gather.
    Returns (ids, pre-level residuals, codewords, loss, final residual)."""
    res = x.float()
    cbs = codebooks.float()
    loss = torch.zeros(res.shape[0], dtype=torch.float32, device=res.device)
    ids, residuals, embs = [], [], []
    for level in range(cbs.shape[0]):
        cb = cbs[level]
        dist = (
            torch.sum(res * res, dim=-1, keepdim=True) - 2.0 * (res @ cb.T)
        ) + torch.sum(cb * cb, dim=-1)[None, :]
        idx = torch.argmin(dist, dim=-1)
        emb = cb[idx]
        diff = res - emb
        loss = loss + (1.0 + commitment_weight) * torch.sum(diff * diff, dim=-1)
        ids.append(idx.to(torch.int32))
        residuals.append(res)
        embs.append(emb)
        res = diff
    return torch.stack(ids, dim=-1), residuals, embs, loss, res


def rq_tokenize_plain(x: torch.Tensor, codebooks: torch.Tensor, *,
                      commitment_weight: float = 0.25) -> RqTokenizeOutput:
    """Plain PyTorch twin of the tokenize kernel."""
    ids, _, embs, loss, res = _plain_levels(x, codebooks, commitment_weight)
    emb_sum = torch.zeros_like(res)
    for emb in embs:
        emb_sum = emb_sum + emb
    return RqTokenizeOutput(ids, emb_sum, res, loss)


def rq_quantize_train_plain(x: torch.Tensor, codebooks: torch.Tensor, *,
                            commitment_weight: float = 0.25) -> RqTrainOutput:
    """Plain PyTorch twin of the training forward kernel (no gradients)."""
    ids, residuals, embs, loss, _ = _plain_levels(x, codebooks, commitment_weight)
    return RqTrainOutput(torch.stack(embs, dim=-1), torch.stack(residuals, dim=-1), ids, loss)


def _lib(name: str) -> ctypes.CDLL:
    from rqvae_tpu_torch.ops import _cuda_build

    lib = _cuda_build.load(name)
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        launch = getattr(lib, f"{name}_launch")
        launch.argtypes = [p, p, p, p, p, p, i, i, i, i, ctypes.c_float, i, p]
        launch.restype = i
        describe = getattr(lib, f"{name}_plan")
        describe.argtypes = [i, i, i, i, i, p]
        describe.restype = i
        error_string = getattr(lib, f"{name}_error_string")
        error_string.argtypes = [i]
        error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(name: str, x: torch.Tensor, codebooks: torch.Tensor) -> None:
    if x.dim() != 2 or codebooks.dim() != 3 or x.shape[1] != codebooks.shape[2]:
        raise ValueError(f"{name}: shape mismatch: x {tuple(x.shape)}, "
                         f"codebooks {tuple(codebooks.shape)}")
    if x.device != codebooks.device:
        raise ValueError(f"{name}: x on {x.device}, codebooks on {codebooks.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda (kernel) or cpu (plain), got {x.device}")


def kernel_plan(name: str, b: int, n_levels: int, k: int, d: int, *, device=None) -> dict:
    """The plan that ``csrc/<name>.cu`` launches for these shapes on a CUDA
    ``device``, as the library computes it, with ``clusters``: how many of
    its clusters (the resident kernel's CTAs) the device holds at once (0:
    it cannot launch)."""
    lib = _lib(name)
    dev = torch.device("cuda") if device is None else torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    out = (ctypes.c_longlong * 11)()
    err = getattr(lib, f"{name}_plan")(b, n_levels, k, d, index, ctypes.addressof(out))
    got = dict(zip(PLAN_FIELDS + ("clusters",), list(out)))
    if err != 0 and got["rows"] == 0:  # no plan: it was refused
        raise RuntimeError(f"{name} plan failed: {getattr(lib, f'{name}_error_string')(err).decode()}")
    return got


def _launch(name: str, x: torch.Tensor, codebooks: torch.Tensor, out_a: torch.Tensor,
            out_b: torch.Tensor, ids: torch.Tensor, loss: torch.Tensor,
            commitment_weight: float) -> None:
    """Launch ``csrc/<name>.cu`` on float32 contiguous CUDA operands."""
    if x.dtype != torch.float32 or codebooks.dtype != torch.float32:
        raise TypeError(f"{name} takes float32, got {x.dtype} / {codebooks.dtype}")
    if not (x.is_contiguous() and codebooks.is_contiguous()):
        raise ValueError(f"{name} needs contiguous x and codebooks")
    b, d = x.shape
    n_levels, k, _ = codebooks.shape
    if d > MAX_D or d % 4:
        raise ValueError(f"{name} takes D a multiple of 4, at most {MAX_D}; got {d}")
    lib = _lib(name)
    dev_index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = getattr(lib, f"{name}_launch")(
        x.data_ptr(), codebooks.data_ptr(), ids.data_ptr(), out_a.data_ptr(), out_b.data_ptr(),
        loss.data_ptr(), b, n_levels, k, d, float(commitment_weight), dev_index, stream,
    )
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        try:
            taken = kernel_plan(name, b, n_levels, k, d, device=x.device)
        except RuntimeError as e:
            taken = str(e)
        raise RuntimeError(f"{name} launch failed: {msg} "
                           f"(plan {taken} for B {b}, {n_levels} x {k} x {d})")


def _pad4(t: torch.Tensor) -> torch.Tensor:
    """fp32, contiguous, 16-byte aligned, the last dim zero-padded to a
    multiple of 4 (the kernels copy codes as float4s); zeros change no
    distance or loss."""
    pad = -t.shape[-1] % 4
    t = torch.nn.functional.pad(t.float(), (0, pad)) if pad else t.float().contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def rq_tokenize(x: torch.Tensor, codebooks: torch.Tensor, *,
                commitment_weight: float = 0.25) -> RqTokenizeOutput:
    """Multi-level residual quantization, hard argmin. x (B, D) fp32,
    codebooks (L, K, D) fp32 (effective, post SimVQ / l2-norm)."""
    _check("rq_tokenize", x, codebooks)
    if x.device.type == "cpu":
        return rq_tokenize_plain(x, codebooks, commitment_weight=commitment_weight)
    if x.dtype != torch.float32 or codebooks.dtype != torch.float32:
        raise TypeError(f"rq_tokenize takes float32, got {x.dtype} / {codebooks.dtype}")
    b, d = x.shape
    n_levels = codebooks.shape[0]
    xp, cbs = _pad4(x), _pad4(codebooks)
    ids = torch.empty((b, n_levels), dtype=torch.int32, device=x.device)
    emb = torch.empty((b, xp.shape[1]), dtype=torch.float32, device=x.device)
    res = torch.empty((b, xp.shape[1]), dtype=torch.float32, device=x.device)
    loss = torch.empty((b,), dtype=torch.float32, device=x.device)
    if b:
        _launch("rq_tokenize", xp, cbs, emb, res, ids, loss, commitment_weight)
        rq_tokenize.launches += 1
    if xp.shape[1] != d:
        emb, res = emb[:, :d], res[:, :d]
    return RqTokenizeOutput(ids, emb, res, loss)


rq_tokenize.launches = 0


def _rq_train_forward(x: torch.Tensor, codebooks: torch.Tensor,
                      commitment_weight: float) -> RqTrainOutput:
    """The forward kernel on CUDA (inputs cast to fp32, as the TPU kernel's
    ``astype(f32)``), its twin on the CPU."""
    if x.device.type == "cpu":
        return rq_quantize_train_plain(x, codebooks, commitment_weight=commitment_weight)
    b, d = x.shape
    n_levels = codebooks.shape[0]
    xp, cbs = _pad4(x), _pad4(codebooks)
    dp = xp.shape[1]
    ids = torch.empty((b, n_levels), dtype=torch.int32, device=x.device)
    residuals = torch.empty((n_levels, b, dp), dtype=torch.float32, device=x.device)
    embs = torch.empty((n_levels, b, dp), dtype=torch.float32, device=x.device)
    loss = torch.empty((b,), dtype=torch.float32, device=x.device)
    if b:
        _launch("rq_quantize_train", xp, cbs, residuals, embs, ids, loss, commitment_weight)
        rq_quantize_train.launches += 1
    if dp != d:
        embs, residuals = embs[..., :d], residuals[..., :d]
    return RqTrainOutput(embs.permute(1, 2, 0), residuals.permute(1, 2, 0), ids, loss)


def _rq_train_backward(mode: str, beta: float, embs, residuals, sem_ids, d_emb, d_res,
                       d_loss, k: int):
    """Estimator-exact gradients, levels processed in reverse (the JAX
    package's ``_rq_train_bwd``). Per level l (res = pre-level residual, emb =
    selected codeword):

    * quantize loss: d/d emb -> 2 (emb - res) g_loss (codebook rows, scatter);
      d/d res -> 2 beta (res - emb) g_loss (commitment term);
    * residual chain res_{l+1} = res_l - emb_out_l: g_res_l += g_res_{l+1},
      g_embout_l -= g_res_{l+1};
    * estimator: STE g_res_l += g_embout; rotation trick
      g_res_l += s (g - 2 w (w.g) + 2 u (q_hat.g)) with u = res/|res|,
      q_hat = emb/|emb|, w = unit(u + q_hat), s = |emb|/|res| (eps values as
      in models/quantize.py).
    """
    n_levels = embs.shape[-1]
    g_loss = d_loss[:, None].float()
    g_res_next = torch.zeros(embs.shape[:2], dtype=torch.float32, device=embs.device)
    d_cb = []
    for level in reversed(range(n_levels)):
        res = residuals[..., level].float()
        emb = embs[..., level].float()
        g_embout = d_emb[..., level].float() - g_res_next
        g_res = g_res_next + d_res[..., level].float()

        d_cb.append(torch.zeros((k, res.shape[1]), dtype=torch.float32, device=res.device)
                    .index_add_(0, sem_ids[:, level].long(), 2.0 * g_loss * (emb - res)))
        g_res = g_res + 2.0 * beta * g_loss * (res - emb)

        if mode == "STE":
            g_res = g_res + g_embout
        elif mode == "ROTATION_TRICK":
            rn = torch.linalg.vector_norm(res, dim=-1, keepdim=True)
            en = torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
            u = res / (rn + 1e-8)
            qh = emb / (en + 1e-8)
            w = u + qh
            w = w / torch.sqrt(torch.clamp(torch.sum(w * w, dim=-1, keepdim=True), min=1e-6**2))
            s = en / (rn + 1e-6)
            g = g_embout
            g_res = g_res + s * (
                g
                - 2.0 * w * torch.sum(w * g, dim=-1, keepdim=True)
                + 2.0 * u * torch.sum(qh * g, dim=-1, keepdim=True)
            )
        else:
            raise ValueError(f"unsupported fused training mode: {mode}")
        g_res_next = g_res
    return g_res_next, torch.stack(d_cb[::-1], dim=0)


class _RqQuantizeTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, codebooks, mode, commitment_weight):
        out = _rq_train_forward(x, codebooks, commitment_weight)
        ctx.save_for_backward(out.embeddings, out.residuals, out.sem_ids)
        ctx.mode, ctx.beta = mode, commitment_weight
        ctx.x_dtype, ctx.cb_dtype, ctx.k = x.dtype, codebooks.dtype, codebooks.shape[1]
        ctx.mark_non_differentiable(out.sem_ids)
        return tuple(out)

    @staticmethod
    def backward(ctx, d_emb, d_res, _d_ids, d_loss):
        embs, residuals, sem_ids = ctx.saved_tensors
        g_x, g_cb = _rq_train_backward(ctx.mode, ctx.beta, embs, residuals, sem_ids,
                                       d_emb, d_res, d_loss, ctx.k)
        return g_x.to(ctx.x_dtype), g_cb.to(ctx.cb_dtype), None, None


def rq_quantize_train(x: torch.Tensor, codebooks: torch.Tensor, mode: str = "ROTATION_TRICK",
                      commitment_weight: float = 0.25) -> RqTrainOutput:
    """Fused multi-level residual quantization, training path. x (B, D) fp32
    or bf16 (cast to fp32 for the kernel), codebooks (L, K, D) effective
    codebooks; ``mode`` is "STE" or "ROTATION_TRICK". Outputs are fp32."""
    _check("rq_quantize_train", x, codebooks)
    if mode not in ("STE", "ROTATION_TRICK"):
        raise ValueError(f"unsupported fused training mode: {mode}")
    return RqTrainOutput(*_RqQuantizeTrain.apply(x, codebooks, mode, commitment_weight))


rq_quantize_train.launches = 0
