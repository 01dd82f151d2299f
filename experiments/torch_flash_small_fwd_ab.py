"""Time the short attention forward (``flash_attention_small_fwd``) of one or
more source trees in turns on one GPU (H = 8, Dh = 64, bf16), each shape
with and without a key mask:

* the Amazon decoder step's three shapes at batch 256: encoder self 81 x 81,
  cross 5 x 81 (both under an Amazon-like mask: histories right-padded to
  1 + 4 n of 81 keys, n uniform in 1..10 items, ~0.29 of the keys valid as
  on the recorded batch's 0.294), decoder self 5 x 5 causal (ragged mask);
* serving: the beam-folded cross 32 x 81 at batch 256 (Amazon-like mask)
  and a decode step's 1 x 4 at batch 256 x 32 beams (ragged mask);
* the ML-32M short bucket 241 x 241 and its cross 5 x 241 at batch 16
  (ragged mask: lengths uniform in 1..Nk).

The masked runs give their first batch row no valid key. Without a mask
every key is valid, where nothing can be skipped. Operands are strided
views of one fused (B, N, 3, H, Dh) projection, as the model hands them
over, made from ``--seed``.

Each tree runs in its own process (its own ``build/kernels``), which builds
the forward, holds it against the plain twin (bf16 2e-2; the row with no
valid key exactly 0, m = -1e30, inv = 0) and feeds its m and inv to the
backward (held against its twin too), then times the forward by CUDA events
over 50 back-to-back calls (host enqueue included) and by torch.profiler
device time over 20, beside the bound (and, where the tree exports it,
the kernel's launch plan: pairs a unit, stages, warps, shared memory and
CTAs an SM). The timers and the bound are
``chip_smoke.py``'s (``cuda_ms``, ``_device_ms``, ``_short_bound``), read
from the repository that holds this script, so every tree is timed alike.
The trees run in the order given, then reversed: parent, change, change,
parent for two trees.

    python3 experiments/torch_flash_small_fwd_ab.py --tree <parent dir> --tree .

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
# name: (B, Nq, Nk, causal, mask kind)
SHAPES = {"encoder_self": (256, 81, 81, False, "amazon"),
          "cross": (256, 5, 81, False, "amazon"),
          "decoder_self": (256, 5, 5, True, "ragged"),
          "beam_cross_32x81": (256, 32, 81, False, "amazon"),
          "decode_1x4": (8192, 1, 4, False, "ragged"),
          "bucket_241": (16, 241, 241, False, "ragged"),
          "cross_5x241": (16, 5, 241, False, "ragged")}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def key_mask(kind, b, nk, gen, dev):
    """A right-padded (B, Nk) key mask whose first row has no valid key."""
    import torch

    if kind == "amazon":
        lengths = 1 + 4 * torch.randint(1, 11, (b,), device=dev, generator=gen)
    else:
        lengths = torch.randint(1, nk + 1, (b,), device=dev, generator=gen)
    km = torch.arange(nk, device=dev)[None] < lengths[:, None]
    km[0] = False
    return km


def worker(seed: int) -> dict:
    import torch

    from rqvae_tpu_torch.ops import _cuda_build
    from rqvae_tpu_torch.ops import flash_attention as fa

    cs = _chip_smoke()
    _cuda_build.build_all(["flash_attention_small_fwd", "flash_attention_small_bwd"])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    h, dh = 8, 64
    out = {}
    for kind, (b, nq, nk, causal, mask_kind) in SHAPES.items():
        proj_q = torch.randn((b, nq, 3, h, dh), device=dev, generator=gen).to(torch.bfloat16)
        proj_k = torch.randn((b, nk, 3, h, dh), device=dev, generator=gen).to(torch.bfloat16)
        q = proj_q[:, :, 0].transpose(1, 2)
        k, v = proj_k[:, :, 1].transpose(1, 2), proj_k[:, :, 2].transpose(1, 2)
        g = torch.randn((b, h, nq, dh), device=dev, generator=gen).to(torch.bfloat16)
        masked = key_mask(mask_kind, b, nk, gen, dev)
        for label, km in (("masked", masked), ("full", None)):
            o, m, inv = fa.flash_attention_small_fwd(q, k, v, k_mask=km, causal=causal)
            ref = fa.flash_attention_small_plain(q, k, v, k_mask=km, causal=causal)
            grads = fa.flash_attention_small_bwd(q, k, v, g, m, inv, k_mask=km, causal=causal)
            want = fa.flash_attention_small_bwd_plain(q, k, v, g, k_mask=km, causal=causal)
            torch.cuda.synchronize()
            errs = {}
            for name, x, y in (("out", o, ref),) + tuple(zip(("dq", "dk", "dv"), grads, want)):
                x, y = x.float(), y.float()
                errs[name] = float((x - y).abs().max())
                assert torch.isfinite(x).all(), f"{kind} {label} {name}: non-finite"
                assert torch.allclose(x, y, rtol=2e-2, atol=2e-2), \
                    f"{kind} {label} {name}: {errs[name]}"
            if km is not None:
                assert float(o[0].abs().max()) == 0.0 and bool((m[0] == -1e30).all()) \
                    and bool((inv[0] == 0).all()), f"{kind}: the row with no valid key"
            del o, ref, grads, want
            def fn():
                return fa.flash_attention_small_fwd(q, k, v, k_mask=km, causal=causal)
            bound = cs._short_bound(q, k, km, causal, "fwd")
            out[f"{kind}/{label}"] = dict(
                shape=[b, h, nq, nk], causal=causal, errs=errs, ms=cs.cuda_ms(fn, 50),
                device_ms=cs._device_ms(fn, 20, "small_fwd"), bound_ms=bound["bound_ms"],
                bound_by=bound["bound_by"], valid_key_share=bound["valid_key_share"])
            if hasattr(fa, "small_fwd_plan"):   # trees from before the launch plan was exported
                out[f"{kind}/{label}"]["plan"] = fa.small_fwd_plan(b * h, nq, nk)
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
