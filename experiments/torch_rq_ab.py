"""Time the quantizer kernels (``rq_quantize_train``, ``rq_tokenize``) of
two source trees in turns on one GPU, at the four shapes the stage-1 and
serving paths give them:

* ``train_flagship``: rq_quantize_train, B = 64, 3 x 256 x 32 (a flagship
  stage-1 step, ``configs/rqvae_amazon.json``);
* ``train_stretch``: rq_quantize_train, B = 1024, 4 x 2048 x 64 (``bench.py``'s
  ``rqvae_stretch``);
* ``tokenize_amazon``: rq_tokenize, 4,096 rows, 3 x 256 x 32 (a corpus
  precompute chunk);
* ``tokenize_stretch``: rq_tokenize, 4,096 rows, 4 x 2048 x 64.

Each tree's ``rqvae_tpu_torch/csrc/rq_tokenize.cu`` and
``rq_quantize_train.cu`` are built by nvcc (all at once) with the ``rq``
namespace renamed per tree (``-Drq=rq_<tag>``), so that two builds loaded in
one process share no symbol, and called through ctypes on the same operands
(made from ``--seed``: x ~ N(0, 1), codebooks ~ 0.7 N(0, 1)). Both C
interfaces are known: the parent's takes a norms scratch, this tree's does
not. Each result is held against this checkout's plain twins (ids equal off
near-ties, values to 1e-5), then timed by CUDA events over 50 back-to-back
launches and by torch.profiler device time over 20, beside the bound
(``chip_smoke._rq_bound``). The trees run parent, change, change, parent.
Each turn also times an empty kernel (one CTA of 32 threads) launched through
ctypes the same way: the launch floor the calls are read against.

With ``--plans`` this tree's kernels are also built under every plan of the
cluster kernel (``-DRQ_FORCE_ROWS=R -DRQ_FORCE_CLUSTER=C``: 16 or 32 rows,
1, 2 or 4 CTAs a cluster) and timed (device time) at the four shapes. With
``--stretch N`` the stretch stage-1 step (``chip_smoke.py``'s phase 12: the
``rqvae_stretch`` model, 16-step device chunks, bf16) runs in a process of
each tree in turns, parent, change, change, parent (``--stretch-turns``: T
turns of that order), and records N readings of ``STRETCH_CHUNKS`` timed
chunks each after a warm-up chunk, the host's time in the kernel's launcher
and one traced chunk (device busy time, idle share).

    git archive <parent> | tar -x -C build/trees/parent
    python3 experiments/torch_rq_ab.py --parent build/trees/parent [--plans] \
        [--stretch N [--stretch-turns T] [--stretch-only]]

prints one JSON line per run and the card's name and power limit.
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
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
NAMES = ("rq_tokenize", "rq_quantize_train")
# shape name: (kernel, B, L, K, D)
SHAPES = {"train_flagship": ("rq_quantize_train", 64, 3, 256, 32),
          "train_stretch": ("rq_quantize_train", 1024, 4, 2048, 64),
          "tokenize_amazon": ("rq_tokenize", 4096, 3, 256, 32),
          "tokenize_stretch": ("rq_tokenize", 4096, 4, 2048, 64)}
PLANS = tuple((r, c) for r in (16, 32) for c in (1, 2, 4))
BETA = 0.25
EMPTY_CU = r"""
#include <cuda_runtime.h>
__global__ void rq_ab_empty() {}
extern "C" int rq_ab_empty_launch(void* stream) {
  rq_ab_empty<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build(specs: dict) -> dict:
    """nvcc every {key: (source, extra flags)} at once; returns {key: CDLL}."""
    from rqvae_tpu_torch.ops import _cuda_build

    out_dir = ROOT / "build" / "rq_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for key, (src, flags) in specs.items():
        lib = out_dir / ("-".join(map(str, key)) + ".so")
        cmd = [_cuda_build._nvcc(), *_cuda_build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v",
               *flags, "-shared", "-Xcompiler", "-fPIC", "-o", str(lib), str(src)]
        procs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), lib)
    libs = {}
    for key, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "bytes stack" in line:
                print(f"ptxas {key}: {line.strip()}", file=sys.stderr)
        libs[key] = ctypes.CDLL(str(lib))
    return libs


class Kernel:
    """One tree's library of one kernel, called on fp32 CUDA tensors."""

    def __init__(self, lib, name: str, tag: str):
        p, i = ctypes.c_void_p, ctypes.c_int
        self.name, self.tag = name, tag
        self.launch = getattr(lib, f"{name}_launch")
        self.with_norms = not hasattr(lib, f"{name}_plan")
        self.launch.argtypes = [p] * (7 if self.with_norms else 6) + [i, i, i, i, ctypes.c_float,
                                                                      i, p]
        self.launch.restype = i
        self.error = getattr(lib, f"{name}_error_string")
        self.error.argtypes, self.error.restype = [i], ctypes.c_char_p

    def outputs(self, x, cbs):
        import torch

        b, d = x.shape
        n_levels, k, _ = cbs.shape
        shape = (n_levels, b, d) if self.name == "rq_quantize_train" else (b, d)
        return dict(ids=torch.empty((b, n_levels), dtype=torch.int32, device=x.device),
                    a=torch.empty(shape, device=x.device), b=torch.empty(shape, device=x.device),
                    loss=torch.empty((b,), device=x.device),
                    norms=torch.empty((n_levels * k,), device=x.device))

    def __call__(self, x, cbs, out):
        import torch

        b, d = x.shape
        n_levels, k, _ = cbs.shape
        ptrs = [x.data_ptr(), cbs.data_ptr()] + ([out["norms"].data_ptr()] if self.with_norms else [])
        ptrs += [out[n].data_ptr() for n in ("ids", "a", "b", "loss")]
        err = self.launch(*ptrs, b, n_levels, k, d, BETA, x.device.index or 0,
                          torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.name} ({self.tag}) launch failed: {self.error(err).decode()}")


def hold(cs, kernel, x, cbs, out) -> dict:
    """The kernel's outputs against this checkout's plain twin."""
    import torch

    from rqvae_tpu_torch.ops import quantize_kernels as qk

    torch.cuda.synchronize()
    if kernel.name == "rq_quantize_train":
        want = qk.rq_quantize_train_plain(x, cbs, commitment_weight=BETA)
        pairs = ((out["b"], want.embeddings.permute(2, 0, 1)),
                 (out["a"], want.residuals.permute(2, 0, 1)), (out["loss"], want.quantize_loss))
    else:
        want = qk.rq_tokenize_plain(x, cbs, commitment_weight=BETA)
        pairs = ((out["a"], want.emb_sum), (out["b"], want.residual), (out["loss"], want.loss))
    differ = (out["ids"] != want.sem_ids).any(-1)
    near = cs._near_ties(x, cbs, want.sem_ids)
    assert not bool((differ & ~near).any()), f"{kernel.name} ({kernel.tag}) ids differ off near-ties"
    err = 0.0
    for got, ref in pairs:
        got, ref = (got[..., ~differ, :], ref[..., ~differ, :]) if got.dim() == 3 else \
            (got[~differ], ref[~differ])
        assert torch.allclose(got, ref, rtol=1e-5, atol=1e-5), f"{kernel.name} ({kernel.tag}) values"
        err = max(err, float((got - ref).abs().max()))
    return dict(id_rows_differ=int(differ.sum()), near_tie_rows=int(near.sum()), max_abs_err=err)


def stretch_child(tree: str, reps: int) -> int:
    """The stretch step of ``tree``'s package: ``reps`` readings of
    ``STRETCH_CHUNKS`` chunks after a warm-up chunk, as chip_smoke's phase 12."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import rqvae_tpu_torch
    from rqvae_tpu_torch.models import rqvae
    from rqvae_tpu_torch.ops import quantize_kernels as qk
    from rqvae_tpu_torch.train import optim
    from rqvae_tpu_torch.train import train_rqvae as tr

    cs = _chip_smoke()
    dev = torch.device("cuda")
    mcfg = rqvae.RqVaeConfig(input_dim=cs.INPUT_DIM, embed_dim=cs.STRETCH_EMBED,
                             hidden_dims=(512, 256, 128), codebook_size=cs.STRETCH_K,
                             n_layers=cs.STRETCH_LEVELS, n_cat_feats=0,
                             codebook_mode="ROTATION_TRICK")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 2)
    corpus = torch.randn((cs.N_ITEMS, cs.INPUT_DIM), generator=gen, device=dev)
    params = rqvae.init(torch.Generator().manual_seed(cs.SEED), mcfg, device=dev)
    params = rqvae.kmeans_prime(params, mcfg, corpus, gen)
    opt = optim.adamw(5e-4, 0.01)
    opt_state = opt.init(params)
    chunk = tr.make_device_chunk(mcfg, opt, 1, torch.bfloat16, cs.STRETCH_BATCH, cs.STRETCH_STEPS)
    params, opt_state, m = chunk(params, opt_state, corpus, gen, 0.2)  # warm-up (and the build)
    torch.cuda.synchronize()
    # the host's time inside the kernel's launcher (ctypes call included)
    real_launch, host_s = qk._launch, [0.0]

    def timed_launch(*a, **kw):
        t0 = time.perf_counter()
        real_launch(*a, **kw)
        host_s[0] += time.perf_counter() - t0

    qk._launch = timed_launch
    qk.rq_quantize_train.launches = 0
    readings = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(cs.STRETCH_CHUNKS):
            params, opt_state, m = chunk(params, opt_state, corpus, gen, 0.2)
        torch.cuda.synchronize()
        readings.append((time.perf_counter() - t0) * 1e3 / (cs.STRETCH_CHUNKS * cs.STRETCH_STEPS))
    steps = reps * cs.STRETCH_CHUNKS * cs.STRETCH_STEPS
    assert qk.rq_quantize_train.launches == steps, qk.rq_quantize_train.launches
    profile = cs._profile(lambda: chunk(params, opt_state, corpus, gen, 0.2), top=4)
    print(json.dumps({"stretch_step_ms": readings, "package": rqvae_tpu_torch.__file__,
                      "rq_quantize_train_launches": qk.rq_quantize_train.launches,
                      "launcher_host_ms": host_s[0] * 1e3 / steps,
                      "chunk_profile": {k: profile[k] for k in ("wall_ms", "device_busy_ms",
                                                                "device_idle_share",
                                                                "top_device_ops")},
                      "steps": steps, "last_loss": float(m["total_loss"])}), flush=True)
    return 0


def time_turn(cs, tag, kernels, data, empty) -> dict:
    """One tree's turn: each shape held and timed, and the empty launch."""
    import torch

    row = {"tree": tag}
    for shape, (name, b, n_levels, k, d) in SHAPES.items():
        kernel = kernels[tag, name]
        x, cbs = data[shape]
        out = kernel.outputs(x, cbs)
        kernel(x, cbs, out)
        held = hold(cs, kernel, x, cbs, out)
        bound, by = cs._rq_bound(b, n_levels, k, d, name == "rq_quantize_train")
        row[shape] = dict(ms=cs.cuda_ms(lambda: kernel(x, cbs, out), 50),
                          device_ms=cs._device_ms(lambda: kernel(x, cbs, out), 20, f"rq_{tag}::"),
                          bound_ms=bound, bound_by=by, **held)
    stream = torch.cuda.current_stream().cuda_stream
    row["empty_launch"] = dict(ms=cs.cuda_ms(lambda: empty(stream), 50),
                               device_ms=cs._device_ms(lambda: empty(stream), 20, "rq_ab_empty"))
    return row


def kernels_ab(cs, trees: dict, args) -> None:
    """The kernels of both trees in turns at the four shapes (and, with
    ``--plans``, this tree's under every cluster plan)."""
    import torch

    specs = {(tag, name): (pathlib.Path(tree) / "rqvae_tpu_torch" / "csrc" / f"{name}.cu",
                           [f"-Drq=rq_{tag}"])
             for tag, tree in trees.items() for name in NAMES}
    empty_src = ROOT / "build" / "rq_ab" / "empty.cu"
    empty_src.parent.mkdir(parents=True, exist_ok=True)
    empty_src.write_text(EMPTY_CU)
    specs["empty", "launch"] = (empty_src, [])
    if args.plans:
        for r, c in PLANS:
            for name in NAMES:
                specs[f"p{r}x{c}", name] = (ROOT / "rqvae_tpu_torch" / "csrc" / f"{name}.cu",
                                            [f"-Drq=rq_p{r}x{c}", f"-DRQ_FORCE_ROWS={r}",
                                             f"-DRQ_FORCE_CLUSTER={c}"])
    t0 = time.perf_counter()
    libs = build(specs)
    print(json.dumps({"build_s": time.perf_counter() - t0, "libraries": len(libs)}), flush=True)
    empty = libs["empty", "launch"].rq_ab_empty_launch
    empty.argtypes, empty.restype = [ctypes.c_void_p], ctypes.c_int
    kernels = {key: Kernel(lib, key[1], key[0]) for key, lib in libs.items() if key[0] != "empty"}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    data = {}
    for shape, (name, b, n_levels, k, d) in SHAPES.items():
        data[shape] = (torch.randn((b, d), device=dev, generator=gen),
                       0.7 * torch.randn((n_levels, k, d), device=dev, generator=gen))
    for tag in ("parent", "change", "change", "parent"):
        print(json.dumps(time_turn(cs, tag, kernels, data, empty)), flush=True)
    if args.plans:
        for shape, (name, b, n_levels, k, d) in SHAPES.items():
            x, cbs = data[shape]
            times = {}
            for r, c in PLANS:
                kernel = kernels[f"p{r}x{c}", name]
                out = kernel.outputs(x, cbs)
                try:
                    kernel(x, cbs, out)
                except RuntimeError as e:   # a cluster the device cannot hold
                    times[f"{r}x{c}"] = str(e)
                    continue
                hold(cs, kernel, x, cbs, out)
                times[f"{r}x{c}"] = cs._device_ms(lambda: kernel(x, cbs, out), 20, f"rq_p{r}x{c}::")
            print(json.dumps({"plans": shape, "device_ms": times}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="the parent's source tree")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plans", action="store_true", help="also time every cluster plan of this tree")
    ap.add_argument("--stretch", type=int, default=0, metavar="N",
                    help="also time the stretch step of each tree in turns, N readings a turn")
    ap.add_argument("--stretch-turns", type=int, default=4, metavar="T",
                    help="stretch turns: T (a multiple of 4) of parent, change, change, parent")
    ap.add_argument("--stretch-only", action="store_true", help="skip the kernels' A/B")
    ap.add_argument("--stretch-tree", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.stretch_tree:
        return stretch_child(args.stretch_tree, args.stretch)
    if not args.parent:
        ap.error("--parent is required")
    import torch

    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    trees = {"parent": os.path.abspath(args.parent), "change": str(ROOT)}
    if not args.stretch_only:
        kernels_ab(cs, trees, args)
    if args.stretch:
        for tag in ("parent", "change", "change", "parent") * (args.stretch_turns // 4):
            proc = subprocess.run([sys.executable, __file__, "--stretch-tree", trees[tag],
                                   "--stretch", str(args.stretch)], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"stretch step of {tag} failed:\n{proc.stderr[-4000:]}")
            got = json.loads(proc.stdout.strip().splitlines()[-1])
            print(json.dumps({"stretch": tag, **got}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
