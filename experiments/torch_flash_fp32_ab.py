"""The fp32 flat and span flash kernels of two source trees on one GPU, in
turns (parent, change, change, parent), at the three shapes the shipped
MovieLens decoder configs give them, and those configs' training steps.

Kernels (one process): each tree's ``rqvae_tpu_torch/csrc/flash_attention_
{fwd,bwd,spans_fwd,spans_bwd}.cu`` is built by nvcc (all at once) with the
``flash`` namespace renamed per tree (``-Dflash=flash_<tag>``), so that two
builds loaded in one process share no symbol, and called through this
checkout's wrappers (``ops/flash_attention``) with the library swapped in;
a tree whose libraries export no ``*_route`` runs the CUDA cores at fp32.
The operands are made from ``--seed``:

* ``ml1m_flat``: B = 128, H = 8, N = 801, Dh = 64, a crop mask drawn as
  ``chip_smoke._crop_lengths`` draws ML training crops (``configs/
  decoder_ml1m.json``: batch 128, 200-item windows);
* ``ml32m_long``: B = 32, H = 6, N = 785 (``configs/decoder_ml32m.json``'s
  long bucket at 196 items), the same crop rule;
* ``ml32m_packed``: 16 rows x 8 slots of 808 tokens, H = 6, span bounds of
  packed crops (a segment's 4 tokens an item attend its window and its
  slot's user token).

With ``--phase-operands`` they are ``chip_smoke.py``'s phases 32-34's own
operands instead (``phase_operands``: the seeded ML fixtures, phase 31's
RQ-VAEs, the first ``train()`` step of each shipped config).

Each result is held against this checkout's twins (1e-4,
``chip_smoke._fp32_held``) and timed by ``chip_smoke._fp32_flash_times``:
CUDA events, profiler device time, the twin,
``F.scaled_dot_product_attention`` in fp32 with the mask as an additive
bias (and the backend its kernels name), both bounds.

Steps (``--steps N``): a process of each tree in turns runs N timed fp32
training steps (after 3 warm-up steps) of the ML-1M flat step (batch 128,
801 tokens, the decoder_ml1m.json widths), the ML-32M long-bucket step
(32 rows of 785 tokens, decoder_ml32m.json's widths) and the packed step
(16 rows x 8 slots of 200 items, the same widths), and one traced step of
each (device busy time, idle share). Those processes import the tree's own
package, which builds the tree's kernels from its own sources.

    git archive <parent> | tar -x -C build/trees/parent
    python3 experiments/torch_flash_fp32_ab.py --parent build/trees/parent \
        [--phase-operands] [--steps N] [--no-kernels]

prints one JSON line a turn and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
NAMES = ("flash_attention_fwd", "flash_attention_bwd", "flash_attention_spans_fwd",
         "flash_attention_spans_bwd")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build(trees: dict) -> dict:
    """nvcc each tree's four flash libraries at once; {tag: {name: CDLL}}."""
    from rqvae_tpu_torch.ops import _cuda_build

    out_dir = ROOT / "build" / "flash_ab"
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
    libs = {}
    for (tag, name), (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag} {name}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "bytes stack" in line:
                print(f"ptxas {tag} {name}: {line.strip()}", file=sys.stderr)
        libs.setdefault(tag, {})[name] = _with_route(ctypes.CDLL(str(lib)), name)
    return libs


def _with_route(lib, name: str):
    """The library, or for one that exports no ``<prefix>_route`` (a tree
    before the routes were exported: fp32 ran on the CUDA cores there) an
    object that adds one answering 0."""
    from rqvae_tpu_torch.ops import flash_attention as fa

    prefix = fa._C_FUNCTIONS[name][0]
    if hasattr(lib, f"{prefix}_route"):
        return lib

    class Shim:
        def __getattr__(self, attr):
            if attr == f"{prefix}_route":
                def route(*_):
                    return 0
                route.argtypes = None
                setattr(self, attr, route)
                return route
            return getattr(lib, attr)

    return Shim()


def operands(dev, seed: int) -> dict:
    """{shape: (kind, (q, k, v, g), mask arguments)} in fp32, from ``seed``."""
    import numpy as np
    import torch

    cs = _chip_smoke()
    rng = np.random.RandomState(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def qkvg(b, h, n):
        return [torch.randn((b, n, h, 64), device=dev, generator=gen).transpose(1, 2)
                for _ in range(4)]

    out = {}
    for shape, (b, h, items) in (("ml1m_flat", (128, 8, 200)), ("ml32m_long", (32, 6, 196))):
        n = 4 * items + 1
        lengths = cs._crop_lengths(rng, b, items)
        # the user token and 4 tokens an item of the crop, valid first as the batches hold them
        km = torch.from_numpy(np.arange(n)[None, :] < 1 + 4 * lengths[:, None]).to(dev)
        out[shape] = ("flat", qkvg(b, h, n), dict(k_mask=km))
    rows, slots, items = 16, 8, 200
    n = slots + 4 * items
    lo = np.zeros((rows, n), np.int32)
    hi = np.zeros((rows, n), np.int32)
    ex = np.full((rows, n), -1, np.int32)
    for r in range(rows):
        pos = slots
        for s in range(slots):
            length = 4 * int(cs._crop_lengths(rng, 1, items)[0])
            if pos + length > n:
                break
            win = slice(pos, pos + length)
            lo[r, win], hi[r, win], ex[r, win] = pos, pos + length, s
            lo[r, s], hi[r, s] = pos, pos + length   # the user token attends its segment
            pos += length
    spans = [torch.from_numpy(a).to(dev) for a in (lo, hi, ex)]
    out["ml32m_packed"] = ("spans", qkvg(rows, 6, n), dict(zip(("lo", "hi", "extra"), spans)))
    return out


def phase_operands(dev) -> dict:
    """The three shapes' operands as ``chip_smoke.py``'s phases 32-34 record
    them: the layer-0 encoder operands of the first step with a flash call
    (of 256 tokens or more) of ``configs/decoder_ml1m.json``, of
    ``decoder_ml32m.json``'s long bucket and of its packed branch
    (``packed_rows`` = ``ML_PACK_ROWS``; g drawn as phase 33 draws it),
    each config as shipped on the seeded ML fixtures over phase 31's
    RQ-VAEs, with g at unit RMS. Writes the fixtures under ``build/`` and
    removes them."""
    import shutil
    import tempfile

    import torch

    from rqvae_tpu_torch.ops import attention as attn_ops
    from rqvae_tpu_torch.train import train_decoder as td

    cs = _chip_smoke()
    (ROOT / "build").mkdir(exist_ok=True)
    work = tempfile.mkdtemp(dir=ROOT / "build")
    try:
        roots = {}
        roots["ml32m"], roots["ml1m"], _ = cs._movielens_data(work)
        _, ck32, ck1m, _ = cs._ml_stage1(dev, work, roots)
        once = ["iterations=5", "partial_eval_every=1000", "full_eval_every=1000",
                "save_model_every=1000", f"seed={cs.SEED}"]

        def first_step(name, root, ckpt, *extra):
            cfg = cs._ml_config(td.DecoderTrainConfig, name, [
                f"data_path={roots[root]}", f"pretrained_rqvae_path={ckpt}",
                f"save_dir_root={work}/{name}-{len(extra)}", *once, *extra])
            td.train(cfg, logger=cs._Records(), device=dev)

        out = {}
        for shape, name, root, ckpt in (("ml1m_flat", "decoder_ml1m", "ml1m", ck1m),
                                        ("ml32m_long", "decoder_ml32m", "ml32m", ck32)):
            with cs._flash_recorder(256) as rec:
                first_step(name, root, ckpt)
            out[shape] = ("flat", [rec["q"], rec["k"], rec["v"], rec["g"].contiguous()],
                          dict(k_mask=rec["k_mask"], causal=rec["causal"]))
        seen, real = [], attn_ops.flash_attention_spans

        def record(q, k, v, lo, hi, extra):
            if not seen and q.requires_grad:
                seen.append((q.detach(), k.detach(), v.detach(), lo, hi, extra))
            return real(q, k, v, lo, hi, extra)

        attn_ops.flash_attention_spans = record
        try:
            first_step("decoder_ml32m", "ml32m", ck32, "length_buckets=1",
                       f"packed_rows={cs.ML_PACK_ROWS}")
        finally:
            attn_ops.flash_attention_spans = real
        q, k, v, lo, hi, extra = seen[0]
        g = torch.randn(q.shape, generator=torch.Generator(device=q.device).manual_seed(
            cs.SEED + 33), device=q.device)
        out["ml32m_packed"] = ("spans", [q, k, v, g], dict(lo=lo, hi=hi, extra=extra))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for _, args, _ in out.values():
        args[3] = args[3] / args[3].pow(2).mean().sqrt()
    return out


def kernel_turn(tag: str, libs: dict, cases: dict) -> dict:
    from rqvae_tpu_torch.ops import _cuda_build

    cs = _chip_smoke()
    for name in NAMES:
        _cuda_build._LIBS[name] = libs[tag][name]
    res = {}
    for shape, (kind, args, mask) in cases.items():
        res[shape] = dict(held=cs._fp32_held(kind, *args, **mask),
                          **cs._fp32_flash_times(kind, *args, sdpa=tag == "change", **mask))
    return res


def step_worker(tree: str) -> int:
    """Time the three fp32 steps with ``tree``'s package; one JSON line."""
    sys.path.insert(0, str(pathlib.Path(tree).resolve()))
    import numpy as np
    import torch

    from rqvae_tpu_torch.data import packing
    from rqvae_tpu_torch.data.dataset import SeqDataset
    from rqvae_tpu_torch.models import retrieval
    from rqvae_tpu_torch.ops import flash_attention as fa
    from rqvae_tpu_torch.tokenizer import semids
    from rqvae_tpu_torch.train import optim
    from rqvae_tpu_torch.train import train_decoder as td

    cs = _chip_smoke()
    args = json.loads(sys.argv[3])
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"package": str(pathlib.Path(fa.__file__).resolve().parents[2])}
    rng = np.random.RandomState(args["seed"])
    for name, (width, heads, dropout, batch, items, n_items) in (
            ("ml1m_flat", (512, 8, 0.3, 128, 200, 3883)),
            ("ml32m_long", (384, 6, 0.1, 32, 196, 84432)),
            ("ml32m_packed", (384, 6, 0.1, 16, 200, 84432))):
        cfg = retrieval.RetrievalConfig(embedding_dim=128, attn_dim=width, dropout=dropout,
                                        num_heads=heads, n_layers=8, num_embeddings=256,
                                        sem_id_dim=4, max_pos=800)
        base = torch.from_numpy(rng.randint(0, 256, (n_items, 3)).astype(np.int32)).to(dev)
        index = semids.build_index(torch.cat([base, semids.dedup_column(base, 256)[:, None]], 1),
                                   codebook_size=256)
        params = retrieval.init(torch.Generator().manual_seed(args["seed"]), cfg, device=dev)
        opt = optim.adamw(3e-4, 0.035)
        state = [params, opt.init(params)]
        gen = torch.Generator(device=dev).manual_seed(args["seed"] + 1)
        if name == "ml32m_packed":
            seqs = SeqDataset(user_ids=np.arange(4096, dtype=np.int32),
                              item_ids=rng.randint(0, n_items, (4096, items)).astype(np.int32),
                              item_ids_fut=rng.randint(0, n_items, (4096, 1)).astype(np.int32),
                              max_seq_len=items)
            packer = packing.SequencePacker(seqs=seqs, rng=np.random.default_rng(0), rows=batch,
                                            slots=8)
            for _ in range(3):
                packer.next_batch()
            data = packing.to_device(packer.next_batch()[0], dev)
            step = td.make_packed_step(cfg, opt, index, torch.float32)
        else:
            ids = rng.randint(0, n_items, (batch, items)).astype(np.int32)
            lengths = cs._crop_lengths(rng, batch, items)
            ids = np.where(np.arange(items)[None, :] < lengths[:, None], ids, -1)
            data = cs._seq_batch(ids, rng.randint(0, n_items, (batch, 1)).astype(np.int32),
                                 np.arange(batch, dtype=np.int32), dev)
            data = type(data)(*(t[None] for t in data))
            step = td.make_train_step(cfg, opt, index, 1, torch.float32, 4)

        def run():
            state[0], state[1], _ = step(state[0], state[1], data, gen)

        for _ in range(3):
            run()
        out[name] = dict(step_ms=cs.wall_ms(run, args["steps"]), steps=args["steps"],
                         profile=cs._profile(run, top=6))
        del params, state[:], data
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


def main() -> int:
    import torch

    if sys.argv[1:2] == ["--step-worker"]:
        return step_worker(sys.argv[2])
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="the parent tree's root")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=0, help="timed steps a config and turn (0: none)")
    ap.add_argument("--no-kernels", action="store_true")
    ap.add_argument("--phase-operands", action="store_true",
                    help="time the kernels on chip_smoke.py's phases 32-34 operands (~2.5 "
                         "minutes of fixtures and stage 1 first) instead of seeded ones")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_flash_fp32_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    trees = {"parent": a.parent, "change": str(ROOT)}
    turns = ("parent", "change", "change", "parent")
    if not a.no_kernels:
        libs = build(trees)
        dev = torch.device("cuda")
        cases = phase_operands(dev) if a.phase_operands else operands(dev, a.seed)
        print(json.dumps({"operands": {k: dict(kind=c[0], shape=list(c[1][0].shape))
                                       for k, c in cases.items()}}), flush=True)
        for tag in turns:
            print(json.dumps({"kernels": tag, **kernel_turn(tag, libs, cases)}), flush=True)
    if a.steps:
        for tag in turns:
            proc = subprocess.run([sys.executable, __file__, "--step-worker", trees[tag],
                                   json.dumps({"seed": a.seed, "steps": a.steps})],
                                  capture_output=True, text=True, timeout=1800)
            if proc.returncode != 0:
                print(proc.stderr[-4000:], file=sys.stderr)
                raise RuntimeError(f"step worker for {tag} failed")
            print(json.dumps({"steps": tag, **json.loads(proc.stdout.strip().splitlines()[-1])}),
                  flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
