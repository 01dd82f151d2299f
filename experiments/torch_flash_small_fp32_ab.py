"""The fp32 short-attention kernels (``flash_attention_small``, Dh = 64) of
two source trees on one GPU, in turns (parent, change, change, parent), at
the shapes the shipped decoder configs give them with
``RQVAE_TPU_SHORT_FLASH=1``.

Each tree's ``rqvae_tpu_torch/csrc/flash_attention_small_{fwd,bwd}.cu`` is
built by nvcc (all at once) with the ``flash`` namespace renamed per tree
(``-Dflash=flash_<tag>``), so that two builds loaded in one process share no
symbol, and called through this checkout's wrappers (``ops/flash_attention``)
with the library swapped in; a tree whose libraries export no
``flash_small_bwd_gate`` (before the fp32 tensor-core route) answers every
route question with the CUDA cores, where it ran fp32. A tree that does not
build is reported and left out of the turns.

The operands:

* ``encoder_81x81``, ``decoder_5x5`` (causal), ``cross_5x81``: layer 0's
  operands of one fp32 ``make_train_step`` of ``configs/decoder_amazon.json``
  (batch 256, 8 heads x 64, 81 + 5 tokens; seeded weights, a seeded
  12,101-item index, 256 synthetic users' cropped 20-item histories),
  recorded through the plain twin, the upstream gradient at unit RMS;
* ``beam_cross_32x81`` and ``decode_1xT``: the first short-forward call of
  those shapes in one beam search (k = 32, 256 candidates) of the same
  weights in fp32; the backward on a seeded unit-RMS g;
* ``ml32m_short_bucket``: ``configs/decoder_ml32m.json``'s short bucket,
  32 rows x 6 heads x 209 tokens (52 items), crop lengths as
  ``chip_smoke._crop_lengths`` draws them, seeded operands.

Each result is held against this checkout's twins (1e-4,
``chip_smoke._fp32_held``) and timed by ``chip_smoke._fp32_flash_times``:
CUDA events, profiler device time, the twin, fp32
``F.scaled_dot_product_attention`` with the mask as an additive bias (and
the backend its kernels name; in the change's turns), both bounds; the
change's turns add the fp32 kernels' launch plans. Once, bf16 SDPA at the
bf16 strip kernel's shapes (B = 256, H = 8, 241 x 241 and 5 x 241, ragged
masks as ``experiments/torch_flash_small_bwd_ab.py`` draws them).

    git archive <parent> | tar -x -C build/trees/parent
    python3 experiments/torch_flash_small_fp32_ab.py --parent build/trees/parent

prints the card's name and power limit, one JSON line a turn, the bf16 SDPA
line, and the card again; exits 1 if a tree did not build or a result
missed its bound.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
NAMES = ("flash_attention_small_fwd", "flash_attention_small_bwd")
STEP_SHAPES = ("encoder_81x81", "decoder_5x5", "cross_5x81")
PER_STEP = 4   # launches of each step shape a step: 4 encoder self, 4 decoder self, 4 cross


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _CudaCoresOnly:
    """A library of a tree before the fp32 tensor-core route: every route
    question answers 0 (the CUDA cores, where such a tree ran fp32); its
    route and plan exports take other arguments, so they are not called."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, attr):
        if attr in ("flash_small_fwd_route", "flash_small_bwd_gate"):
            def route(*_):
                return 0
            route.argtypes = None
            setattr(self, attr, route)
            return route
        return getattr(self._lib, attr)


def build(trees: dict) -> tuple:
    """nvcc each tree's two short libraries at once; ({tag: {name: CDLL}},
    {tag: nvcc log lines}); a tree that fails is left out."""
    from rqvae_tpu_torch.ops import _cuda_build

    out_dir = ROOT / "build" / "flash_small_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, tree in trees.items():
        for name in NAMES:
            lib = out_dir / f"{tag}-{name}.so"
            cmd = [_cuda_build._nvcc(), *_cuda_build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas",
                   "-v", f"-Dflash=flash_{tag}", "-shared", "-Xcompiler", "-fPIC", "-o", str(lib),
                   str(pathlib.Path(tree) / "rqvae_tpu_torch" / "csrc" / f"{name}.cu")]
            procs[tag, name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True), lib)
    libs, logs, failed = {}, {}, set()
    for (tag, name), (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"nvcc failed for {tag} {name}:\n{log[-6000:]}", file=sys.stderr, flush=True)
            failed.add(tag)
            continue
        logs.setdefault(tag, []).extend(
            f"{name}: {ln.strip()}" for ln in log.splitlines()
            if "registers" in ln or "bytes stack" in ln or "Compiling" in ln)
        libs.setdefault(tag, {})[name] = ctypes.CDLL(str(lib))
    for tag, pair in libs.items():   # a tree before the fp32 route: no backward gate exported
        if not hasattr(pair[NAMES[1]], "flash_small_bwd_gate"):
            libs[tag] = {name: _CudaCoresOnly(lib) for name, lib in pair.items()}
    return {t: v for t, v in libs.items() if t not in failed}, logs, failed


def _unit(g):
    return g / g.float().pow(2).mean().sqrt()


def operands(dev, seed: int) -> dict:
    """{shape: ((q, k, v, g), mask arguments)} in fp32 (module docstring)."""
    import numpy as np
    import torch

    from rqvae_tpu_torch.data import dataset as dataset_lib
    from rqvae_tpu_torch.data.synthetic import synthetic_items, synthetic_sequences
    from rqvae_tpu_torch.models import generation, retrieval
    from rqvae_tpu_torch.ops import attention as attn_ops
    from rqvae_tpu_torch.ops import flash_attention as fa
    from rqvae_tpu_torch.tokenizer import semids
    from rqvae_tpu_torch.train import optim
    from rqvae_tpu_torch.train import train_decoder as td
    from rqvae_tpu_torch.utils import config as config_lib

    cs = _chip_smoke()
    cfg = config_lib.load_config(td.DecoderTrainConfig, str(ROOT / "configs" / "decoder_amazon.json"),
                                 ["dataset=SYNTHETIC", f"vae_input_dim={cs.INPUT_DIM}"])
    if cfg.amp or cfg.batch_size != 256:
        raise RuntimeError(f"decoder_amazon.json is not as shipped: amp {cfg.amp}, "
                           f"batch {cfg.batch_size}")
    model_cfg = cfg.retrieval_config(cs.N_HIST)
    params = retrieval.init(torch.Generator().manual_seed(seed), model_cfg, device=dev)
    rng = np.random.RandomState(seed)
    base = torch.from_numpy(rng.randint(0, 256, (cs.N_ITEMS, 3)).astype(np.int32)).to(dev)
    index = semids.build_index(torch.cat([base, semids.dedup_column(base, 256)[:, None]], 1),
                               codebook_size=256)
    items = synthetic_items(cs.N_ITEMS, cs.INPUT_DIM, seed=seed)
    users, _ = synthetic_sequences(cs.N_ITEMS, n_users=cfg.batch_size, seed=seed + 3)
    batch = dataset_lib.make_seq_batch(users.sample_batch(np.random.default_rng(seed),
                                                          cfg.batch_size, subsample=True),
                                       items.x, with_features=False)
    rec, real = {}, attn_ops.flash_attention_small

    def record(q, k, v, *, k_mask=None, causal=False):   # the plain twin: no kernel involved
        out = fa.flash_attention_small_plain(q, k, v, k_mask=k_mask, causal=causal)
        kind = ("decoder_5x5" if causal else
                "encoder_81x81" if q.shape[2] == k.shape[2] else "cross_5x81")
        if out.requires_grad and kind not in rec:
            entry = rec[kind] = dict(q=q.detach(), k=k.detach(), v=v.detach(), k_mask=k_mask,
                                     causal=causal)
            out.register_hook(lambda g, e=entry: e.__setitem__("g", g.detach()))
        return out

    serve = {}

    def record_serve(q, k, v, *, k_mask=None, causal=False):
        key = ("beam_cross_32x81" if q.shape[2] == 32 else
               f"decode_1x{k.shape[2]}" if q.shape[2] == 1 else None)
        if key and key not in serve:
            serve[key] = dict(q=q, k=k, v=v, k_mask=k_mask, causal=causal)
        return fa.flash_attention_small_plain(q, k, v, k_mask=k_mask, causal=causal)

    env = os.environ.get(cs.SHORT_FLASH_ENV)
    os.environ[cs.SHORT_FLASH_ENV] = "1"
    try:
        attn_ops.flash_attention_small = record
        flat = dataset_lib.to_device(type(batch)(*(a[None] for a in batch)), dev)
        step = td.make_train_step(model_cfg, optim.adamw(3e-4, 0.035), index, 1, torch.float32, 4)
        p = [params, optim.adamw(3e-4, 0.035).init(params)]
        step(p[0], p[1], flat, torch.Generator(device=dev).manual_seed(seed))
        attn_ops.flash_attention_small = record_serve
        tok = semids.tokenize_sequences(index, dataset_lib.to_device(batch, dev))
        with torch.no_grad():
            generation.generate_next_sem_ids(params, model_cfg, index,
                                             tok._replace(sem_ids_fut=None, token_type_ids_fut=None),
                                             k=cs.BEAMS, n_candidates=256)
    finally:
        attn_ops.flash_attention_small = real
        if env is None:
            os.environ.pop(cs.SHORT_FLASH_ENV)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    out = {kind: ([e["q"], e["k"], e["v"], _unit(e["g"])], dict(k_mask=e["k_mask"],
                                                                causal=e["causal"]))
           for kind, e in sorted(rec.items())}
    decode = max((key for key in serve if key.startswith("decode_")),
                  key=lambda key: int(key.split("x")[1]))   # the longest cache: 1 x T
    for key, e in sorted(serve.items()):
        if key.startswith("decode_") and key != decode:
            continue
        g = torch.randn(e["q"].shape, device=dev, generator=gen)
        out[key] = ([e["q"], e["k"], e["v"], g], dict(k_mask=e["k_mask"], causal=e["causal"]))
    b, h, items_n = 32, 6, 52
    n = 4 * items_n + 1
    lengths = cs._crop_lengths(rng, b, items_n)
    km = torch.from_numpy(np.arange(n)[None, :] < 1 + 4 * lengths[:, None]).to(dev)
    qkvg = [torch.randn((b, n, h, 64), device=dev, generator=gen).transpose(1, 2)
            for _ in range(4)]
    out["ml32m_short_bucket"] = (qkvg, dict(k_mask=km, causal=False))
    return out


def kernel_turn(tag: str, libs: dict, cases: dict) -> dict:
    import torch

    from rqvae_tpu_torch.ops import _cuda_build
    from rqvae_tpu_torch.ops import flash_attention as fa

    cs = _chip_smoke()
    for name in NAMES:
        _cuda_build._LIBS[name] = libs[tag][name]
    res = {}
    for shape, (args, mask) in cases.items():
        held = cs._fp32_held("small", *args, **mask)
        res[shape] = dict(shape=list(args[0].shape[:3]) + [args[1].shape[2]], held=held,
                          launches_per_step=PER_STEP if shape in STEP_SHAPES else None,
                          **cs._fp32_flash_times("small", *args, sdpa=tag == "change", **mask))
        if tag == "change":
            dev = torch.cuda.current_device()
            res[shape]["plans"] = {"fwd": fa.small_fwd_tf32_plan(args[1].shape[2], dev),
                                   "bwd": fa.small_bwd_tf32_plan(dev)}
    return res


def bf16_sdpa(dev, seed: int) -> dict:
    """bf16 SDPA at the strip kernel's shapes: forward and backward ms (CUDA
    events and profiler device time), the mask as an additive bias."""
    import torch
    import torch.nn.functional as F

    from rqvae_tpu_torch.ops import flash_attention as fa

    cs = _chip_smoke()
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, h, dh = 256, 8, 64
    out = {}
    for kind, (nq, nk) in (("bucket_241", (241, 241)), ("cross_5x241", (5, 241))):
        q, g = (torch.randn((b, h, nq, dh), device=dev, generator=gen).to(torch.bfloat16)
                for _ in range(2))
        k, v = (torch.randn((b, h, nk, dh), device=dev, generator=gen).to(torch.bfloat16)
                for _ in range(2))
        lengths = torch.randint(1, nk + 1, (b,), device=dev, generator=gen)
        km = torch.arange(nk, device=dev)[None] < lengths[:, None]
        km[0] = False
        mask = fa._key_masker(fa.mask_bias(km, b, nk, dev), False)(
            torch.zeros((b, 1, 1, nk), device=dev)).to(torch.bfloat16)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]

        def lib_f():
            return F.scaled_dot_product_attention(*leaves, attn_mask=mask)

        def lib_fb():
            torch.autograd.backward(lib_f(), g)

        with torch.no_grad():
            fwd = cs.cuda_ms(lib_f, 20)
            fwd_dev = cs._device_ms(lib_f, 10)
        both = cs.cuda_ms(lib_fb, 20)
        out[kind] = dict(shape=[b, h, nq, nk], fwd_ms=fwd, bwd_ms=both - fwd,
                         fwd_device_ms=fwd_dev, bwd_device_ms=cs._device_ms(lib_fb, 10) - fwd_dev,
                         backend=cs._sdpa_backend(lib_fb)["backend"])
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="the parent tree's root")
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_flash_small_fp32_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs, logs, failed = build({"parent": a.parent, "change": str(ROOT)})
    print(json.dumps({"ptxas": logs, "failed_builds": sorted(failed)}), flush=True)
    dev = torch.device("cuda")
    cases = operands(dev, a.seed)
    print(json.dumps({"operands": {k: dict(shape=list(c[0][0].shape), nk=c[0][1].shape[2],
                                           **{m: bool(v) for m, v in c[1].items()
                                              if m == "causal"})
                                   for k, c in cases.items()}}), flush=True)
    ok = not failed
    for tag in ("parent", "change", "change", "parent"):
        if tag not in libs:
            continue
        res = kernel_turn(tag, libs, cases)
        ok = ok and all(h[1] for r in res.values() for h in r["held"].values())
        print(json.dumps({"kernels": tag, **res}), flush=True)
    print(json.dumps({"bf16_sdpa_strip_shapes": bf16_sdpa(dev, a.seed)}), flush=True)
    print(smi, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
