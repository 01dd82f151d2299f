"""Time the short attention kernels (``flash_attention_small_fwd`` /
``flash_attention_small_bwd``) of one or more source trees in turns on one
GPU (B = 256, H = 8, Dh = 64, bf16): the Amazon decoder step's three shapes
(encoder self 81 x 81 under a ragged key mask, decoder self 5 x 5 causal,
cross 5 x 81 under the encoder's mask), a decode step's 1 x 4, and the
backward's key-strip shapes, 241 x 241 (the ML-32M short bucket) and 5 x
241, under ragged masks. Operands are strided views of one fused (B, N, 3,
H, Dh) projection, as the model hands them over, made from ``--seed``.

Each tree runs in its own process (its own ``build/kernels``), which builds
the two kernels, holds them against the plain twins (bf16 2e-2, a batch row
with no valid key exactly 0), then times each by CUDA events over 50
back-to-back calls (host enqueue included) and by torch.profiler device
time over 20, beside the bound. The timers and the bound are
``chip_smoke.py``'s (``cuda_ms``, ``_device_ms``, ``_short_bound``), read
from the repository that holds this script, so every tree is timed alike.
The trees run in the order given, then reversed: parent, change, change,
parent for two trees.

    python3 experiments/torch_flash_small_bwd_ab.py --tree <parent dir> --tree .

prints one JSON line per run and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
# name: (Nq, Nk, causal, ragged key mask)
SHAPES = {"encoder_self": (81, 81, False, True), "decoder_self": (5, 5, True, False),
          "cross": (5, 81, False, True), "decode_1x4": (1, 4, False, False),
          "bucket_241": (241, 241, False, True), "cross_5x241": (5, 241, False, True)}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(seed: int) -> dict:
    import torch

    from rqvae_tpu_torch.ops import _cuda_build
    from rqvae_tpu_torch.ops import flash_attention as fa

    cs = _chip_smoke()
    logs = _cuda_build.build_all(["flash_attention_small_fwd", "flash_attention_small_bwd"])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, h, dh = 256, 8, 64
    out = {"ptxas": [ln for ln in logs["flash_attention_small_bwd"].splitlines()
                     if "registers" in ln or "spill" in ln or "Compiling" in ln]}
    for kind, (nq, nk, causal, masked) in SHAPES.items():
        proj_q = torch.randn((b, nq, 3, h, dh), device=dev, generator=gen).to(torch.bfloat16)
        proj_k = torch.randn((b, nk, 3, h, dh), device=dev, generator=gen).to(torch.bfloat16)
        q = proj_q[:, :, 0].transpose(1, 2)
        k, v = proj_k[:, :, 1].transpose(1, 2), proj_k[:, :, 2].transpose(1, 2)
        g = torch.randn((b, h, nq, dh), device=dev, generator=gen).to(torch.bfloat16)
        km = None
        if masked:
            lengths = torch.randint(1, nk + 1, (b,), device=dev, generator=gen)
            km = torch.arange(nk, device=dev)[None] < lengths[:, None]
            km[0] = False   # a batch row with no valid key
        o, m, inv = fa.flash_attention_small_fwd(q, k, v, k_mask=km, causal=causal)
        grads = fa.flash_attention_small_bwd(q, k, v, g, m, inv, k_mask=km, causal=causal)
        want = fa.flash_attention_small_bwd_plain(q, k, v, g, k_mask=km, causal=causal)
        ref = fa.flash_attention_small_plain(q, k, v, k_mask=km, causal=causal)
        torch.cuda.synchronize()
        errs = {}
        for name, x, y in (("out", o, ref),) + tuple(zip(("dq", "dk", "dv"), grads, want)):
            x, y = x.float(), y.float()
            errs[name] = float((x - y).abs().max())
            assert torch.isfinite(x).all(), f"{kind} {name}: non-finite"
            assert torch.allclose(x, y, rtol=2e-2, atol=2e-2), f"{kind} {name}: {errs[name]}"
        if masked:
            assert all(float(t[0].abs().max()) == 0.0 for t in (o,) + tuple(grads)), \
                f"{kind}: the row with no valid key is not zero"
        del o, grads, want, ref
        fns = {"fwd": lambda: fa.flash_attention_small_fwd(q, k, v, k_mask=km, causal=causal),
               "bwd": lambda: fa.flash_attention_small_bwd(q, k, v, g, m, inv, k_mask=km,
                                                           causal=causal)}
        out[kind] = dict(errs=errs)
        for d, fn in fns.items():
            bound = cs._short_bound(q, k, km, causal, d)
            out[kind][d] = dict(ms=cs.cuda_ms(fn, 50), device_ms=cs._device_ms(fn, 20, f"small_{d}"),
                                bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
                                valid_key_share=bound["valid_key_share"])
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--worker", action="store_true")
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.seed)), flush=True)
        return 0
    trees = [os.path.abspath(t) for t in (args.tree or ["."])]
    order = trees + trees[::-1] if len(trees) > 1 else trees
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    for tree in order:
        cmd = [sys.executable, os.path.abspath(__file__), "--worker", "--seed", str(args.seed)]
        res = subprocess.run(cmd, cwd=tree, capture_output=True, text=True,
                             env={**os.environ, "PYTHONPATH": tree})
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            return 1
        print(json.dumps({"tree": tree, **json.loads(res.stdout.strip().splitlines()[-1])}),
              flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
