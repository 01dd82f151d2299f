"""Time the short attention kernels (``flash_attention_small_fwd`` /
``flash_attention_small_bwd``) of one or more source trees in turns on one
GPU (H = 8, Dh = 64, bf16). At B = 256: the Amazon decoder step's three
shapes (encoder self 81 x 81 under a ragged key mask, decoder self 5 x 5
causal, cross 5 x 81 under the encoder's mask), a decode step's 1 x 4, and
the strips route's 241 x 241 (the ML-32M short bucket) and 5 x 241 under
ragged masks, those two beside bf16 ``F.scaled_dot_product_attention``
(the mask as an additive bias; device time of its forward and of its
forward and backward). At B = 32, the strips route's other cases: 1 x 241,
17 x 241 (two query tiles), a causal 255 x 255, 209 x 96 (Nq > 208 at 96
keys), 241 x 241 with keys 16-47 masked (two dead middle tiles) and every
other key valid with probability 1/2, and 241 x 241 with every key valid.
A ragged mask gives its first batch row no valid key. Operands are strided
views of one fused (B, N, 3, H, Dh) projection, as the model hands them
over, made from ``--seed``.

Each tree runs in its own process (its own ``build/kernels``), which builds
the two kernels, holds them against the plain twins (bf16 2e-2, a batch row
with no valid key exactly 0), then times each by CUDA events over 50
back-to-back calls (host enqueue included) and by torch.profiler device
time over 20, beside the bound, and records the strips route's launch plan
where the tree exports it. The timers and the bound are ``chip_smoke.py``'s
(``cuda_ms``, ``_device_ms``, ``_short_bound``), read from the repository
that holds this script, so every tree is timed alike. The trees run in the
order given, then reversed: parent, change, change, parent for two trees.

    python3 experiments/torch_flash_small_bwd_ab.py --tree <parent dir> --tree . [--shapes a,b]

prints one JSON line per run and the card's name and power limit;
``--shapes`` keeps only the named shapes.
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
# name: (B, Nq, Nk, causal, key mask: None, "ragged" or "dead_middle")
SHAPES = {"encoder_self": (256, 81, 81, False, "ragged"), "decoder_self": (256, 5, 5, True, None),
          "cross": (256, 5, 81, False, "ragged"), "decode_1x4": (256, 1, 4, False, None),
          "bucket_241": (256, 241, 241, False, "ragged"),
          "cross_5x241": (256, 5, 241, False, "ragged"),
          "cross_1x241": (32, 1, 241, False, "ragged"), "q17x241": (32, 17, 241, False, "ragged"),
          "causal_255": (32, 255, 255, True, "ragged"), "tall_209x96": (32, 209, 96, False, "ragged"),
          "dead_middle_241": (32, 241, 241, False, "dead_middle"),
          "all_valid_241": (32, 241, 241, False, None)}
SDPA = ("bucket_241", "cross_5x241")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def key_mask(kind, b, nk, gen, dev):
    """A (B, Nk) key mask whose first row has no valid key: right-padded to
    lengths uniform in 1..Nk ("ragged"), or keys 16-47 masked and the
    others valid with probability 1/2 ("dead_middle")."""
    import torch

    if kind is None:
        return None
    cols = torch.arange(nk, device=dev)[None]
    if kind == "ragged":
        km = cols < torch.randint(1, nk + 1, (b, 1), device=dev, generator=gen)
    else:
        km = (torch.rand((b, nk), device=dev, generator=gen) < 0.5) & ((cols < 16) | (cols >= 48))
    km[0] = False
    return km


def worker(seed: int, names) -> dict:
    import torch
    import torch.nn.functional as F

    from rqvae_tpu_torch.ops import _cuda_build
    from rqvae_tpu_torch.ops import flash_attention as fa

    cs = _chip_smoke()
    logs = _cuda_build.build_all(["flash_attention_small_fwd", "flash_attention_small_bwd"])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    h, dh = 8, 64
    out = {"ptxas": [ln for ln in logs["flash_attention_small_bwd"].splitlines()
                     if "registers" in ln or "spill" in ln or "Compiling" in ln]}
    for kind, (b, nq, nk, causal, mask_kind) in SHAPES.items():
        if names and kind not in names:
            continue
        proj_q = torch.randn((b, nq, 3, h, dh), device=dev, generator=gen).to(torch.bfloat16)
        proj_k = torch.randn((b, nk, 3, h, dh), device=dev, generator=gen).to(torch.bfloat16)
        q = proj_q[:, :, 0].transpose(1, 2)
        k, v = proj_k[:, :, 1].transpose(1, 2), proj_k[:, :, 2].transpose(1, 2)
        g = torch.randn((b, h, nq, dh), device=dev, generator=gen).to(torch.bfloat16)
        km = key_mask(mask_kind, b, nk, gen, dev)
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
        if km is not None:
            assert all(float(t[0].abs().max()) == 0.0 for t in (o,) + tuple(grads)), \
                f"{kind}: the row with no valid key is not zero"
        del o, grads, want, ref
        fns = {"fwd": lambda: fa.flash_attention_small_fwd(q, k, v, k_mask=km, causal=causal),
               "bwd": lambda: fa.flash_attention_small_bwd(q, k, v, g, m, inv, k_mask=km,
                                                           causal=causal)}
        out[kind] = dict(shape=[b, h, nq, nk], causal=causal, errs=errs,
                         route=fa.small_bwd_route(nq, nk))
        for d, fn in fns.items():
            bound = cs._short_bound(q, k, km, causal, d)
            out[kind][d] = dict(ms=cs.cuda_ms(fn, 50), device_ms=cs._device_ms(fn, 20, f"small_{d}"),
                                bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
                                valid_key_share=bound["valid_key_share"])
        if hasattr(fa, "small_bwd_strips_plan") and out[kind]["route"] == "strips":
            out[kind]["plan"] = fa.small_bwd_strips_plan(nq, nk)
        if kind in SDPA:   # bf16 SDPA under the same mask as an additive bias, timed only
            mask = fa._key_masker(fa.mask_bias(km, b, nk, dev), causal)(
                torch.zeros((b, 1, nq, nk), device=dev)).to(q.dtype)
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            lib_f = lambda: F.scaled_dot_product_attention(*leaves, attn_mask=mask)   # noqa: E731
            lib_fb = lambda: torch.autograd.backward(   # noqa: E731
                F.scaled_dot_product_attention(*leaves, attn_mask=mask), g)
            f_dev, fb_dev = cs._device_ms(lib_f, 20), cs._device_ms(lib_fb, 20)
            out[kind]["sdpa"] = dict(fwd_device_ms=f_dev, bwd_device_ms=fb_dev - f_dev,
                                     fwd_ms=cs.cuda_ms(lib_f, 50),
                                     backend=cs._sdpa_backend(lib_fb)["backend"])
            del leaves, mask
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shapes", default="")
    ap.add_argument("--worker", action="store_true")
    args = ap.parse_args()
    names = [n for n in args.shapes.split(",") if n]
    unknown = sorted(set(names) - set(SHAPES))
    if unknown:
        ap.error(f"unknown shapes {unknown}; known: {sorted(SHAPES)}")
    if args.worker:
        print(json.dumps(worker(args.seed, names)), flush=True)
        return 0
    trees = [os.path.abspath(t) for t in (args.tree or ["."])]
    order = trees + trees[::-1] if len(trees) > 1 else trees
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    for tree in order:
        cmd = [sys.executable, os.path.abspath(__file__), "--worker", "--seed", str(args.seed),
               "--shapes", args.shapes]
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
