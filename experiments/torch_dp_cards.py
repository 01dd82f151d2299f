"""Data parallelism across the cards of one host, through the command users
run: ``torchrun --standalone --nproc_per_node=N -m
rqvae_tpu_torch.train.train_rqvae ...`` and then ``... train_decoder ...``
over that stage-1 checkpoint, for N = 1, 2, 4 (up to the cards present).

Each run is the shipped config (``configs/rqvae_amazon.json``: global batch
64, 400 steps in device chunks of 8; ``configs/decoder_amazon.json``: global
batch 256, bf16, ``RQVAE_TPU_SHORT_FLASH=1``, 200 steps) on SYNTHETIC data
(12,101 items, 22,363 users, seed 0), so a rank feeds 64 / N and 256 / N
rows a step. Every rank prints its JSONL metrics; the script reads them all
and reports, per N and stage: the losses rank 0 logged and the largest
relative difference between ranks on any logged loss (they are reduced, so
they must agree), the step ms between the second and the last log and the
global examples a second, and the checkpoint directory's steps (written by
rank 0 alone).

    python3 experiments/torch_dp_cards.py [--cards 1 2 4] [--out <dir>]

On the GPU machine only (NCCL); it prints the card's name and power limit,
a JSON line per run and a summary line last.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile

REPO = pathlib.Path(__file__).resolve().parent.parent
STAGES = {
    "rq": ("rqvae_tpu_torch.train.train_rqvae", "configs/rqvae_amazon.json",
           ["iterations=400", "steps_per_call=8", "log_every=100", "eval_every=400",
            "save_model_every=400"]),
    "decoder": ("rqvae_tpu_torch.train.train_decoder", "configs/decoder_amazon.json",
                ["iterations=200", "log_every=50", "amp=true", "partial_eval_every=200",
                 "full_eval_every=200", "save_model_every=200", "eval_batches=2",
                 "synthetic_n_users=22363", "vae_input_dim=768"]),
}
LOSSES = ("total_loss", "eval_total_loss", "eval_loss")


def _json_objects(text: str) -> list:
    """Every JSON object in the ranks' shared stdout: two ranks' lines can
    land on one line, so objects are read one after another, not by line."""
    decoder, out, i = json.JSONDecoder(), [], text.find("{")
    while i >= 0:
        obj, end = decoder.raw_decode(text, i)
        out.append(obj)
        i = text.find("{", end)
    return out


def run(n: int, stage: str, out: pathlib.Path, timeout: int) -> dict:
    module, config, extra = STAGES[stage]
    args = ["dataset=SYNTHETIC", "synthetic_n_items=12101", "seed=0",
            f"save_dir_root={out}/{stage}", *extra]
    if stage == "decoder":
        args.append(f"pretrained_rqvae_path={out}/rq")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={n}", "-m", module, str(REPO / config), *args]
    env = dict(os.environ, RQVAE_TPU_SHORT_FLASH="1", PYTHONPATH=str(REPO))
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-6000:])
        raise SystemExit(f"torchrun N={n} {stage} exited {proc.returncode}")
    records = _json_objects(proc.stdout)
    by_step = {}
    for r in records:
        for key in LOSSES:
            if key in r:
                by_step.setdefault((key, r["step"]), []).append(r[key])
    spread = max((max(v) - min(v)) / abs(v[0]) for v in by_step.values() if v[0])
    counts = {len(v) for v in by_step.values()}
    logs = sorted({r["step"]: r for r in records if "total_loss" in r}.values(),
                  key=lambda r: r["step"])
    step_ms = ((logs[-1]["wall_s"] - logs[1]["wall_s"]) * 1e3
               / (logs[-1]["step"] - logs[1]["step"]))
    batch = 64 if stage == "rq" else 256
    steps_saved = sorted(p.name for p in (out / stage).glob("step_*"))
    return dict(cards=n, stage=stage, losses=[r["total_loss"] for r in logs],
                ranks_logging=sorted(counts), rank_loss_spread=spread, step_ms=step_ms,
                examples_per_s=batch / (step_ms / 1e3), checkpoints=steps_saved,
                diversity_logged_by=sum("rqvae_entropy" in r for r in records))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cards", type=int, nargs="+", default=[1, 2, 4])
    p.add_argument("--out", default=None, help="work directory (default: a temporary one)")
    p.add_argument("--timeout", type=int, default=900)
    a = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    cards = [n for n in a.cards if n <= torch.cuda.device_count()]
    results = []
    with tempfile.TemporaryDirectory(dir=a.out) as work:
        for n in cards:
            out = pathlib.Path(work) / f"n{n}"
            for stage in ("rq", "decoder"):
                res = run(n, stage, out, a.timeout)
                print(json.dumps(res), flush=True)
                results.append(res)
    print(json.dumps({"dp_cards": results, "device": torch.cuda.get_device_name(0),
                      "count": torch.cuda.device_count()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
