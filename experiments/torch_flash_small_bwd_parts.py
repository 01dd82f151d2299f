#!/usr/bin/env python3
"""Where the bf16 short backward's strips mode (``small_bwd_strips_kernel``,
Nq > 16 with Nk > 96) spends its time, on one GPU: the kernel as it is and
copies of it with one part cut out, timed in turns.

Timing only: each cut variant computes wrong gradients on purpose, so no
variant is held against the twin here (``torch_flash_small_bwd_ab.py`` and
``chip_smoke.py`` hold the kernel as it is). The variants, each a text
patch of ``csrc/flash_attention_small_bwd.cu`` built under
``build/parts/<variant>`` in a namespace of its own:

* ``full``: as it is;
* ``no_sweep``: no c sweep (c from each strip alone);
* ``no_keyside``: no dk / dv products (the key side's loop runs no query tile);
* ``no_query``: no query side (no s, dp, ds, dq; the key side reads stale e / ds);
* ``copies``: neither side: the prologue, the ring's copies and barriers.

Shapes (H = 8, Dh = 64, bf16, ragged key masks whose first row has no valid
key, operands as ``torch_flash_small_bwd_ab.py`` makes them): 241 x 241 at
B = 256 and 17 x 241 at B = 32 (one wave of CTAs). CUDA events over 20
back-to-back launches, variants in the order above and back, three rounds.

    python3 experiments/torch_flash_small_bwd_parts.py

prints one JSON line and the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from rqvae_tpu_torch.ops import _cuda_build  # noqa: E402
from rqvae_tpu_torch.ops import flash_attention as fa  # noqa: E402

NAME = "flash_attention_small_bwd"
KERNEL = "small_bwd_strips_kernel(SMALL_BWD_PARAMS) {"
PATCHES = {
    "full": [],
    "no_sweep": [("const bool sweep = strips > 1;", "const bool sweep = false;")],
    "no_keyside": [("for (int qs = 0; qs < n_qt; ++qs) {", "for (int qs = 0; qs < 0; ++qs) {")],
    "no_query": [("const bool mine = qt < n_qt;", "const bool mine = false;")],
    "copies": [("for (int qs = 0; qs < n_qt; ++qs) {", "for (int qs = 0; qs < 0; ++qs) {"),
               ("const bool mine = qt < n_qt;", "const bool mine = false;")],
}
SHAPES = {"bucket_241": (256, 241, 241), "q17x241": (32, 17, 241)}


def build(variant: str):
    src = (_cuda_build.CSRC / f"{NAME}.cu").read_text()
    head, rest = src.split(KERNEL)
    end = rest.index("\n}\n") + 3   # the kernel's body
    kernel, tail = rest[:end], rest[end:]
    for old, new in PATCHES[variant]:
        if kernel.count(old) != 1:
            raise RuntimeError(f"{variant}: {old!r} is not once in the strips kernel")
        kernel = kernel.replace(old, new)
    alt = ROOT / "build" / "parts" / variant
    shutil.rmtree(alt, ignore_errors=True)
    shutil.copytree(_cuda_build.CSRC, alt / "csrc")
    (alt / "csrc" / f"{NAME}.cu").write_text(head + KERNEL + kernel + tail)
    for f in (alt / "csrc").iterdir():   # a namespace of its own (launcher statics apart)
        if f.suffix in (".cu", ".cuh"):
            f.write_text(f.read_text().replace("namespace flash {", f"namespace flash_{variant} {{")
                         .replace("namespace flash;", f"namespace flash_{variant};")
                         .replace("flash::", f"flash_{variant}::"))
    csrc, bdir = _cuda_build.CSRC, _cuda_build.BUILD_DIR
    _cuda_build.CSRC, _cuda_build.BUILD_DIR = alt / "csrc", alt / "kernels"
    try:
        log = _cuda_build.build_all([NAME])[NAME]
        lib = ctypes.CDLL(str(_cuda_build._target(NAME)[1]))
    finally:
        _cuda_build.CSRC, _cuda_build.BUILD_DIR = csrc, bdir
    regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
    return lib, regs


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


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    libs, regs = {}, {}
    for v in PATCHES:
        libs[v], regs[v] = build(v)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    h, dh = 8, 64
    ops = {}
    for kind, (b, nq, nk) in SHAPES.items():
        proj_q = torch.randn((b, nq, 3, h, dh), device=dev, generator=gen).to(torch.bfloat16)
        proj_k = torch.randn((b, nk, 3, h, dh), device=dev, generator=gen).to(torch.bfloat16)
        q = proj_q[:, :, 0].transpose(1, 2)
        k, v = proj_k[:, :, 1].transpose(1, 2), proj_k[:, :, 2].transpose(1, 2)
        g = torch.randn((b, h, nq, dh), device=dev, generator=gen).to(torch.bfloat16)
        km = torch.arange(nk, device=dev)[None] < torch.randint(1, nk + 1, (b, 1), device=dev,
                                                                 generator=gen)
        km[0] = False
        _, m, inv = fa.flash_attention_small_fwd(q, k, v, k_mask=km)
        ops[kind] = (q, k, v, g, m, inv, km)
    times = {kind: {v: [] for v in PATCHES} for kind in SHAPES}
    order = list(PATCHES) + list(PATCHES)[::-1]
    for _ in range(3):
        for v in order:
            _cuda_build._LIBS[NAME] = libs[v]
            for kind, (q, k, v_, g, m, inv, km) in ops.items():
                times[kind][v].append(cuda_ms(lambda: fa.flash_attention_small_bwd(
                    q, k, v_, g, m, inv, k_mask=km)))
    out = {kind: {v: sorted(t) for v, t in d.items()} for kind, d in times.items()}
    print(json.dumps({"ms": out, "registers": regs}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
