#!/usr/bin/env python3
"""The bf16 wgmma flash forward under the key-bias mask on one GPU: its
overlapped schedule against the serial one, in one process.

``flash_fwd_wg_kernel`` takes its schedule from the mask policy
(``Mask::kFwdOverlap`` in ``csrc/flash_attention_common.cuh``): overlapped, a
tile's e V product runs under the next tile's softmax; serial, it is waited
for at once. The key-bias policy ships the overlapped one. This script builds
``csrc/flash_attention_fwd.cu`` as it is and a copy of ``csrc/`` with the
key-bias policy's flag set to serial (under ``build/``), holds both against
``_plain_fwd`` on edge cases (``out``, ``m``, ``inv``: a crop key mask,
fully masked rows, masked leading tiles, causal, Nq not a multiple of the
block's 128 rows, no mask), then times both with CUDA events in turns
(overlapped, serial, serial, overlapped; three rounds) at the ML-32M flat
shape (B 256, H 8, N 801, Dh 64, bf16, q / k / v strided views of one fused
qkv product) under the training crop's key mask and with every key valid.

Run from the repository root on a machine with a GPU:
``python3 experiments/torch_flash_fwd_schedules.py``. Prints one JSON line.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from rqvae_tpu_torch.ops import _cuda_build  # noqa: E402
from rqvae_tpu_torch.ops import flash_attention as fa  # noqa: E402

SEED = 0
H, DH = 8, 64
NAME = "flash_attention_fwd"
FLAG = "static constexpr bool kFwdOverlap = true;"
ROUNDS = 3


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def build_variants() -> dict:
    """{"overlap": the source as it is, "serial": the key-bias flag flipped}
    as loaded libraries; prints ptxas' registers and spills of each."""
    src, build_dir = _cuda_build.CSRC, _cuda_build.BUILD_DIR
    common = (src / "flash_attention_common.cuh").read_text()
    if common.count(FLAG) != 1:
        raise RuntimeError("the key-bias policy's schedule flag is not where this script expects it")
    alt = ROOT / "build" / "fwd_schedule_serial"
    shutil.rmtree(alt, ignore_errors=True)
    shutil.copytree(src, alt / "csrc")
    (alt / "csrc" / "flash_attention_common.cuh").write_text(
        common.replace(FLAG, FLAG.replace("true", "false")))
    # another namespace, so the copy's function-local statics (the launcher's
    # once-per-device flag) do not bind to the first library's: g++ gives
    # them STB_GNU_UNIQUE, which the loader unifies across libraries
    for f in (alt / "csrc").iterdir():
        if f.suffix in (".cu", ".cuh"):
            f.write_text(f.read_text().replace("namespace flash {", "namespace flash_serial {")
                         .replace("flash::", "flash_serial::"))
    libs = {}
    for variant, csrc, build in (("overlap", src, build_dir),
                                 ("serial", alt / "csrc", alt / "kernels")):
        _cuda_build.CSRC, _cuda_build.BUILD_DIR = csrc, build
        try:
            log = _cuda_build.build_all([NAME])[NAME]
            libs[variant] = ctypes.CDLL(str(_cuda_build._target(NAME)[1]))
        finally:
            _cuda_build.CSRC, _cuda_build.BUILD_DIR = src, build_dir
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "warning", "error")):
                print(f"ptxas {variant}: {line.strip()}", file=sys.stderr)
    return libs


def use(lib) -> None:
    """Point the wrapper at ``lib`` (the wrapper looks its library up on
    every launch)."""
    _cuda_build._LIBS[NAME] = lib


def qkv_views(b, n, gen, dev):
    qkv = torch.randn((b, n, 3 * H * DH), device=dev, generator=gen).to(torch.bfloat16)
    return [t.view(b, n, H, DH).transpose(1, 2) for t in torch.chunk(qkv, 3, dim=-1)]


def crop_lengths(rng, count: int, n_hist: int = 200):
    seqlen = n_hist + 1
    start = rng.randint(0, seqlen - 2, (count,))
    end = start + rng.randint(3, n_hist + 2, (count,))
    return np.minimum(end, seqlen) - start - 1


def check_fwd(name, out, m, inv, ref) -> bool:
    o_ref, m_ref, i_ref = ref
    err = float((out.float() - o_ref.float()).abs().max())
    live = m_ref > -5e29
    ok = err <= 2e-2 * (1 + float(o_ref.float().abs().max()))
    if bool(live.any()):
        m_err = float((m - m_ref)[live].abs().max())
        i_err = float(((inv - i_ref).abs() / i_ref.abs())[live].max())
        ok = ok and m_err <= 1e-5 * float(m_ref[live].abs().max()) and i_err <= 1e-3
    else:
        m_err = i_err = 0.0
    dead = ~live
    ok = ok and bool(torch.equal(m[dead], m_ref[dead])) and bool((inv[dead] == 0).all())
    if bool(dead.any()):
        ok = ok and float(out.float()[dead].abs().max()) == 0.0
    print(f"check {name}: out {err:.3e} m {m_err:.3e} inv rel {i_err:.3e} "
          f"dead rows {int(dead.sum())} -> {'ok' if ok else 'FAIL'}", file=sys.stderr, flush=True)
    return ok


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs = build_variants()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.RandomState(SEED)
    ok = True

    for variant, lib in libs.items():
        use(lib)
        for b, nq, nk, kind in ((4, 801, 801, "crop"), (4, 705, 801, "crop"), (3, 801, 801, "holes"),
                                (3, 801, 801, "late"), (2, 801, 801, "causal"), (2, 130, 300, "none")):
            q, k, v = qkv_views(b, max(nq, nk), gen, dev)
            q, k, v = q[:, :, :nq], k[:, :, :nk], v[:, :, :nk]
            lens = 1 + 4 * crop_lengths(rng, b)
            km = torch.arange(nk, device=dev)[None] < torch.from_numpy(lens).to(dev)[:, None]
            if kind == "holes":
                km = torch.rand((b, nk), device=dev, generator=gen) < 0.5
                km[0] = False
            if kind == "late":
                km = torch.zeros((b, nk), dtype=torch.bool, device=dev)
                km[:, 130:] = True
            if kind == "none":
                km = None
            causal = kind == "causal"
            out, m, inv = fa.flash_attention_fwd(q, k, v, k_mask=km, causal=causal)
            ref = fa._plain_fwd(q, k, v, fa._key_masker(fa.mask_bias(km, b, nk, dev), causal))
            torch.cuda.synchronize()
            ok &= check_fwd(f"{variant} {kind} {b}x{nq}x{nk}", out, m, inv, ref)

    res = {"device": smi, "checks_ok": bool(ok)}
    q, k, v = qkv_views(256, 801, gen, dev)
    lens = 1 + 4 * crop_lengths(np.random.RandomState(SEED), 256)
    km = torch.arange(801, device=dev)[None] < torch.from_numpy(lens).to(dev)[:, None]
    keep = torch.ones((256, 801), dtype=torch.bool, device=dev)
    for shape, mask in (("flat_crop", km), ("flat_all_valid", keep)):
        times = {v: [] for v in libs}
        for _ in range(ROUNDS):
            for variant in ("overlap", "serial", "serial", "overlap"):
                use(libs[variant])
                times[variant].append(cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, k_mask=mask)))
        res[shape] = dict(ms=times, valid_share=float(mask.float().mean()),
                          overlap_wins=max(times["overlap"]) < min(times["serial"]),
                          serial_wins=max(times["serial"]) < min(times["overlap"]))
        print(f"{shape}: {res[shape]}", file=sys.stderr, flush=True)
    use(libs["overlap"])
    print(json.dumps(res), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
