"""Time the children-window step of constrained beam search in two source
trees, in turns on one GPU, on the beam searches' own operands.

Each turn runs in a fresh process whose ``rqvae_tpu_torch`` is the tree's
own (parent, change, change, parent). The process builds the tree's kernels,
runs two beam searches with the tree's package:

* ``amazon``: ``chip_smoke.py``'s phase-3 set-up (the seeded RQ-VAE over
  12,101 items, the bf16 decoder, 256 users x 20 items), k = 32: levels 1-3
  give 8,192 rows;
* ``ml32m``: the 84,432-item index of ``chip_smoke._ml32m_index``, a decoder
  of ``chip_smoke._ml32m_config`` with random bf16 weights, 64 users x 801
  random tokens, k = 32: 2,048 rows;

and records the children-window operands (table, lo, cnt, key0) of every
level through whichever wrapper the tree's ``semids.children_mask`` calls
(``children_window_mask`` in a tree with the Mask epilogue, else
``children_window``). On levels 1-3 it then times, by CUDA events over 100
back-to-back calls and by torch.profiler device time over 20 (each level's
and their mean):

* ``tokens``: the tree's ``children_window`` (the Tokens kernel);
* ``window_to_mask``: what the tree does from the operands to the (R, K)
  mask: its ``children_window_mask`` where it has one, else its
  ``children_window`` followed by ``.long()``, ``zeros`` and ``scatter_``
  (every device op counted), and by device time alone the same with every
  run emptied (a zeroed cnt, made before the trace, so only the route's own
  ops are timed; no key read: the floor of a row's load-and-store chain).

A trace that holds no device event is taken again once; a second empty one
fails the turn. Both are held against the checkout's twins bit for bit, and
the beam search's wall time is recorded beside them (10 calls after a
warm-up; one traced call's device busy time and idle share,
``chip_smoke._profile``). The operands' checksum is printed, so
the trees can be seen to time the same operands.

    git archive <parent> | tar -x -C build/trees/parent
    python3 experiments/torch_children_window_ab.py --parent build/trees/parent \
        [--change build/trees/change]

prints one JSON line per turn and the card's name and power limit.
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


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _searches(cs, dev):
    """{name: (serve function, codebook size)} for the two beam searches."""
    import numpy as np
    import torch

    from rqvae_tpu_torch.data.schemas import TokenizedSeqBatch
    from rqvae_tpu_torch.models import generation, retrieval
    from rqvae_tpu_torch.tokenizer import semids
    from rqvae_tpu_torch.utils import amp

    rq_params, rq_cfg, corpus, dec_params, dec_cfg, seq_batch = cs._amazon_serving_setup(dev)
    index = semids.precompute_corpus_ids(rq_params, rq_cfg, corpus)
    tok = semids.tokenize_sequences(index, seq_batch)
    rng = np.random.RandomState(cs.SEED)
    ml_index = cs._ml32m_index(rng, dev)
    ml_cfg = cs._ml32m_config()
    ml_params = amp.cast_floating(
        retrieval.init(torch.Generator().manual_seed(cs.SEED), ml_cfg, device=dev), torch.bfloat16)
    n_tok = cs.ML_HIST * 4
    users = cs.ML_GEN_BATCH
    ml_tok = TokenizedSeqBatch(
        user_ids=torch.arange(users, device=dev, dtype=torch.int32),
        sem_ids=torch.from_numpy(rng.randint(0, 256, (users, n_tok)).astype(np.int32)).to(dev),
        sem_ids_fut=None, seq_mask=torch.ones((users, n_tok), dtype=torch.bool, device=dev),
        token_type_ids=torch.arange(4, device=dev, dtype=torch.int32).repeat(users, cs.ML_HIST),
        token_type_ids_fut=None)
    return {
        "amazon": (lambda: generation.generate_next_sem_ids(
            dec_params, dec_cfg, index, tok, k=cs.BEAMS, n_candidates=256), index.codebook_size),
        "ml32m": (lambda: generation.generate_next_sem_ids(
            ml_params, ml_cfg, ml_index, ml_tok, k=cs.BEAMS, n_candidates=256),
            ml_index.codebook_size),
    }


def turn(tree: str) -> int:
    """One tree's turn (run in a process of its own)."""
    sys.path.insert(0, tree)
    import torch

    from rqvae_tpu_torch.ops import _cuda_build
    from rqvae_tpu_torch.ops import children_window as tree_cw
    from rqvae_tpu_torch.tokenizer import semids

    cs = _chip_smoke()
    assert pathlib.Path(tree_cw.__file__).resolve().is_relative_to(pathlib.Path(tree).resolve())
    torch.backends.cuda.matmul.allow_tf32 = False
    _cuda_build.build_all(["rq_tokenize", "children_window", "flash_attention_fwd"])
    dev = torch.device("cuda")
    has_mask = hasattr(tree_cw, "children_window_mask")
    row = {"tree": tree, "mask_epilogue": has_mask}
    checkout = _checkout_children_window()
    for name, (serve, k) in _searches(cs, dev).items():
        serve()
        with cs._record_children_window(
                semids, "children_window_mask" if has_mask else "children_window") as calls:
            serve()
        torch.cuda.synchronize()
        ops = calls[1:]

        def tokens(a):
            return tree_cw.children_window(*a, window=k, k_tokens=k)

        def window_to_mask(a):
            if has_mask:
                return tree_cw.children_window_mask(*a, window=k, k_tokens=k)
            return checkout.fold_tokens(tree_cw.children_window(*a, window=k, k_tokens=k), k)

        for a in calls:
            assert torch.equal(tokens(a), checkout.children_window_plain(*a, window=k, k_tokens=k)), \
                f"{name}: tokens"
            assert torch.equal(window_to_mask(a),
                               checkout.children_window_mask_plain(*a, window=k, k_tokens=k)), \
                f"{name}: mask"

        def mean(fn):
            return sum(fn(a) for a in ops) / len(ops)

        # the same operands with every run emptied (cnt = 0): no key is read
        emptied = [(a[0], a[1], torch.zeros_like(a[2]), a[3]) for a in ops]
        row[name] = dict(
            rows=[int(a[1].shape[0]) for a in calls],
            operands_checksum=[int(a[1].long().sum() + 3 * a[2].long().sum() + (a[3] % 1000003).sum())
                               for a in calls],
            tokens=dict(ms=mean(lambda a: cs.cuda_ms(lambda: tokens(a), 100)),
                        device_ms_by_level=[cs._device_ms_measured(lambda a=a: tokens(a), 20,
                                                                   "window_kernel") for a in ops]),
            window_to_mask=dict(ms=mean(lambda a: cs.cuda_ms(lambda: window_to_mask(a), 100)),
                                device_ms_by_level=[
                                    cs._device_ms_measured(lambda a=a: window_to_mask(a), 20)
                                    for a in ops]),
            empty_runs=dict(device_ms_by_level=[
                cs._device_ms_measured(lambda a=a: window_to_mask(a), 20) for a in emptied]),
            generate_ms=cs.wall_ms(serve, 10),
            generate_profile={key: value for key, value in cs._profile(serve).items()
                              if key in ("wall_ms", "device_busy_ms", "device_idle_share")},
        )
        for part in row[name].values():
            if isinstance(part, dict) and "device_ms_by_level" in part:
                part["device_ms"] = sum(part["device_ms_by_level"]) / len(ops)
                if "ms" in part:
                    part["events_minus_device_ms"] = part["ms"] - part["device_ms"]
    print(json.dumps(row), flush=True)
    return 0


def _checkout_children_window():
    """This checkout's ``ops/children_window.py`` (its twins and the fold),
    loaded from its file: the process's package is the tree's."""
    spec = importlib.util.spec_from_file_location(
        "checkout_children_window", ROOT / "rqvae_tpu_torch" / "ops" / "children_window.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="the parent's source tree")
    ap.add_argument("--change", default=str(ROOT), help="the change's source tree (this checkout)")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        return turn(args.turn)
    if not args.parent:
        ap.error("--parent is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    trees = {"parent": os.path.abspath(args.parent), "change": os.path.abspath(args.change)}
    for tag in ("parent", "change", "change", "parent"):
        proc = subprocess.run([sys.executable, __file__, "--turn", trees[tag]],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"turn of {tag} failed:\n{proc.stderr[-6000:]}")
        print(json.dumps({"turn": tag, **json.loads(proc.stdout.strip().splitlines()[-1])}),
              flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
