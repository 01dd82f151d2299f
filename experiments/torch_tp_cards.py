"""Tensor parallelism across the cards of one host (NCCL), against one card.

* Amazon: ``train_decoder.train`` on ``configs/decoder_amazon.json`` (global
  batch 256, bf16, ``RQVAE_TPU_SHORT_FLASH=1``, SYNTHETIC data: 12,101 items,
  22,363 users, seed 0) over a flagship stage-1 checkpoint this script
  trains first on one card (``configs/rqvae_amazon.json``, 100 steps), at
  each ``--amazon`` mesh (data x model; ``tensor_parallel=true`` when the
  model axis is above 1), each rank started by ``torchrun --standalone``.
* ML-32M: the flat train step of ``configs/decoder_ml32m.json``'s model
  (width 384, 6 heads, 4 + 4 layers) at ``bench.py``'s shape (global batch
  256 of cropped 200-item histories, 801 encoder tokens, bf16, AdamW) through
  ``train_decoder.make_train_step``, the step ``train()`` runs (the
  SYNTHETIC loader holds 20-item histories only), at each ``--ml32m`` mesh.

Per run and rank it records the losses (the ranks of a run must agree: the
losses are reduced over the data group and replicated over the model
group), the host ms a step (Amazon: between the second and the last log;
ML-32M: 10 steps after 3) and the collectives a step by kind
(``parallel/tensor.calls`` and the data group's ``mesh.collective_calls``,
counted between two training logs or over the timed steps), and prints the
card's name and power limit, a JSON line per run and a summary line last.

    python3 experiments/torch_tp_cards.py [--amazon 1x1 1x2 2x2 1x4] \\
        [--ml32m 1x1 1x2 2x2] [--out <dir>]

On the GPU machine; a mesh needing more cards than present is skipped.
``--cpu`` rehearses the Amazon runs on the CPU over gloo at a tiny size
(3,000 items, 200 users, batch 8, 20 steps; no ML-32M).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

AMAZON_ITERS = 60
AMAZON_ARGS = ["dataset=SYNTHETIC", "synthetic_n_items=12101", "synthetic_n_users=22363",
               "vae_input_dim=768", "seed=0", f"iterations={AMAZON_ITERS}", "log_every=10",
               "amp=true", f"partial_eval_every={AMAZON_ITERS}", "full_eval_every=0",
               f"save_model_every={AMAZON_ITERS}", "eval_batches=2"]
CPU_ARGS = ["synthetic_n_items=3000", "synthetic_n_users=200", "batch_size=8", "iterations=20",
            "partial_eval_every=20", "save_model_every=20", "eval_batches=1"]
ML_BATCH = 256


def _json_objects(text: str) -> list:
    """Every JSON object in the ranks' shared stdout, read one after another."""
    decoder, out, i = json.JSONDecoder(), [], text.find("{")
    while i >= 0:
        try:
            obj, end = decoder.raw_decode(text, i)
        except json.JSONDecodeError:
            i = text.find("{", i + 1)
            continue
        out.append(obj)
        i = text.find("{", end)
    return out


class _Counted:
    """A metrics sink that keeps each training log with the host time and
    the collectives issued so far."""

    def __init__(self):
        self.records = []

    def log(self, step, metrics, force=False):
        import numpy as np

        from rqvae_tpu_torch.parallel import mesh
        from rqvae_tpu_torch.parallel import tensor as ttp

        self.records.append({"step": step, "t": time.perf_counter(),
                             "calls": {**ttp.calls, "data": mesh.collective_calls},
                             **{k: float(np.asarray(v)) for k, v in metrics.items()}})


def _per_step(a: dict, b: dict, steps: int) -> dict:
    return {k: (b.get(k, 0) - a.get(k, 0)) / steps for k in set(a) | set(b)}


def _worker_amazon(out: str, d: int, m: int, device) -> dict:
    from rqvae_tpu_torch.parallel import mesh
    from rqvae_tpu_torch.train import train_decoder as td
    from rqvae_tpu_torch.utils import config as config_lib

    mesh.maybe_init_distributed(device)
    args = AMAZON_ARGS + (CPU_ARGS if device == "cpu" else []) + [
        f"pretrained_rqvae_path={out}/rq", f"save_dir_root={out}/dec_{d}x{m}",
        f"mesh_shape=[{d},{m}]", f"tensor_parallel={'true' if m > 1 else 'false'}"]
    cfg = config_lib.load_config(td.DecoderTrainConfig, str(REPO / "configs/decoder_amazon.json"),
                                 args)
    rec = _Counted()
    td.train(cfg, logger=rec, device=device)
    logs = [r for r in rec.records if "total_loss" in r]
    steps = logs[-1]["step"] - logs[1]["step"]
    return dict(losses={r["step"]: r["total_loss"] for r in logs},
                eval_loss=[r["eval_loss"] for r in rec.records if "eval_loss" in r],
                step_ms=(logs[-1]["t"] - logs[1]["t"]) * 1e3 / steps,
                collectives_per_step=_per_step(logs[1]["calls"], logs[-1]["calls"], steps))


def _worker_ml32m(out: str, d: int, m: int, device) -> dict:
    import numpy as np
    import torch

    import chip_smoke
    from rqvae_tpu_torch.parallel import mesh
    from rqvae_tpu_torch.parallel import tensor as ttp
    from rqvae_tpu_torch.train import optim
    from rqvae_tpu_torch.train import train_decoder as td

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh.maybe_init_distributed()
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh.make_mesh((d, m), tensor_parallel=m > 1)
    chip_smoke.TP_ML_BATCH = ML_BATCH
    cfg, index, flat, params = chip_smoke._tp_ml32m_inputs(dev)
    cfg = dataclasses.replace(cfg, dropout=0.3)
    rows = mesh.host_block(np.arange(ML_BATCH), mesh.process_local_batch_size(ML_BATCH))
    flat = type(flat)(*(t[:, torch.from_numpy(rows).to(dev)] for t in flat))
    params = mesh.shard_params(params, mesh.retrieval_tp_spec, cfg.num_heads)
    opt = optim.adamw(3e-4, 0.035)
    state = opt.init(params)
    step = td.make_train_step(cfg, opt, index, 1, torch.bfloat16, 4)
    gen = torch.Generator(device=dev).manual_seed(1 + mesh.data_index())
    losses = []
    for _ in range(3):
        params, state, m_ = step(params, state, flat, gen)
        losses.append(float(td._replicated(m_, "mean")["total_loss"]))
    torch.cuda.synchronize()
    ttp.calls.clear()
    mesh.collective_calls = 0
    t0 = time.perf_counter()
    for _ in range(10):
        params, state, m_ = step(params, state, flat, gen)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 10
    per = _per_step({}, {**ttp.calls, "data": mesh.collective_calls}, 10)
    losses.append(float(td._replicated(m_, "mean")["total_loss"]))
    return dict(losses=dict(enumerate(losses)), step_ms=ms, collectives_per_step=per,
                peak_gb=torch.cuda.max_memory_allocated() / 2**30)


def _worker(kind: str, out: str, d: int, m: int, device: str) -> int:
    from rqvae_tpu_torch.parallel import mesh

    res = {"amazon": _worker_amazon, "ml32m": _worker_ml32m}[kind](
        out, d, m, None if device == "cuda" else device)
    print("\n" + json.dumps({"tp_rank": mesh.rank(), "kind": kind, "mesh": [d, m], **res}),
          flush=True)
    return 0


def _run(kind: str, d: int, m: int, out: pathlib.Path, timeout: int, device: str) -> dict:
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={d * m}", str(pathlib.Path(__file__).resolve()), "--worker", kind,
           str(out), str(d), str(m), device]
    env = dict(os.environ, RQVAE_TPU_SHORT_FLASH="1", PYTHONPATH=str(REPO))
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-6000:])
        raise SystemExit(f"{kind} {d}x{m} exited {proc.returncode}")
    ranks = sorted((o for o in _json_objects(proc.stdout) if "tp_rank" in o),
                   key=lambda o: o["tp_rank"])
    if len(ranks) != d * m:
        raise SystemExit(f"{kind} {d}x{m}: {len(ranks)} rank lines of {d * m}")
    spread = 0.0
    for step, v in ranks[0]["losses"].items():
        vals = [r["losses"][step] for r in ranks]
        spread = max(spread, (max(vals) - min(vals)) / abs(vals[0]))
    return dict(kind=kind, mesh=[d, m], ranks=d * m, losses=ranks[0]["losses"],
                rank_losses=[r["losses"] for r in ranks],
                eval_loss=ranks[0].get("eval_loss"), rank_loss_spread=spread,
                step_ms=max(r["step_ms"] for r in ranks),
                collectives_per_step=ranks[0]["collectives_per_step"],
                peak_gb=ranks[0].get("peak_gb"))


def main() -> int:
    if sys.argv[1:2] == ["--worker"]:
        return _worker(sys.argv[2], sys.argv[3], int(sys.argv[4]), int(sys.argv[5]), sys.argv[6])
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--amazon", nargs="*", default=["1x1", "1x2", "2x2", "1x4"])
    p.add_argument("--ml32m", nargs="*", default=["1x1", "1x2", "2x2"])
    p.add_argument("--out", default=None, help="work directory (default: a temporary one)")
    p.add_argument("--timeout", type=int, default=900)
    p.add_argument("--cpu", action="store_true", help="rehearse on the CPU (gloo), tiny sizes")
    a = p.parse_args()
    import torch

    device = "cpu" if a.cpu else "cuda"
    if a.cpu:
        smi, cards, a.ml32m = "cpu rehearsal", 4, []
    elif not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 1
    else:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip()
        cards = torch.cuda.device_count()
    print(smi, flush=True)
    results = []
    with tempfile.TemporaryDirectory(dir=a.out) as work:
        out = pathlib.Path(work)
        rq_args = ["dataset=SYNTHETIC", "synthetic_n_items=12101", "seed=0", "iterations=100",
                   "steps_per_call=8", "log_every=100", "eval_every=100",
                   "save_model_every=100", f"save_dir_root={out}/rq"]
        if a.cpu:
            from rqvae_tpu_torch.train import train_rqvae as tr
            from rqvae_tpu_torch.utils import config as config_lib

            tr.train(config_lib.load_config(
                tr.RqVaeTrainConfig, str(REPO / "configs/rqvae_amazon.json"),
                rq_args + ["synthetic_n_items=3000", "iterations=16", "eval_every=16",
                           "save_model_every=16"]), device="cpu")
        else:
            subprocess.run([sys.executable, "-m", "rqvae_tpu_torch.train.train_rqvae",
                            str(REPO / "configs/rqvae_amazon.json"), *rq_args],
                           cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)), check=True,
                           capture_output=True, timeout=a.timeout)
        for kind, meshes in (("amazon", a.amazon), ("ml32m", a.ml32m)):
            base = None
            for shape in meshes:
                d, m = (int(x) for x in shape.split("x"))
                if d * m > cards:
                    print(f"skip {kind} {shape}: {cards} cards", file=sys.stderr)
                    continue
                res = _run(kind, d, m, out, a.timeout, device)
                if (d, m) == (1, 1):
                    base = res
                if base is not None:
                    res["step_ms_over_one_card"] = res["step_ms"] / base["step_ms"]
                    if d == 1:   # the same rows and dropout draws as one card
                        res["loss_rel_vs_one_card"] = max(
                            abs(v - base["losses"][k]) / abs(base["losses"][k])
                            for k, v in res["losses"].items())
                print(json.dumps(res), flush=True)
                results.append(res)
    print(smi, flush=True)
    print(json.dumps({"tp_cards": results, "count": cards, "card": smi,
                      "device": torch.cuda.get_device_name(0) if not a.cpu else "cpu"}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
