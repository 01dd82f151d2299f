#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving path on one NVIDIA GPU.

Drives ``rqvae_tpu_torch`` end to end at the shipped Amazon widths, with
random weights made from a seed and a seeded synthetic corpus:

  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from ``rqvae_tpu_torch/csrc`` (one nvcc per
     source, in parallel) and print the build time;
  3. main path: tokenize the 12,101 x 768 corpus with the RQ-VAE
     (``precompute_corpus_ids``: 3 x 256 x 32 codebooks, fp32, 4,096-row
     chunks), tokenize 256 users x 20 history items, run constrained beam
     search (``generate_next_sem_ids``: k = 32, exhaustive candidates, bf16
     decoder weights: 4 + 4 layers, width 512, 8 heads) and count h@k / NDCG;
  4. check that both kernels were launched on that path (launch counts are
     zeroed just before it and read just after);
  5. compare each kernel with its plain PyTorch twin on the main path's own
     inputs (the corpus codes per 4,096-row chunk; the beam search's four
     children_window operand sets, recorded in a rerun): ids and child
     tokens exactly (apart from counted near-ties of the tokenizer's
     argmin), sums / residuals / losses to 1e-5;
  6. check the outputs: every beam that is not penalised is a corpus item,
     log-probas are finite and sorted, and a 4-user fp32 run on the GPU
     agrees with the same run on the CPU (the plain twins);
  7. time each kernel and its twin, and the serving path; trace one beam
     search with torch.profiler for the device's busy share and top ops.

TF32 is switched off for matmuls and cuDNN, so fp32 work runs in fp32.

Prints the nvidia-smi line, a ``{"kernels": [...]}`` line, a
``{"serving": {...}}`` line and, last, ``{"ok": true, "device": {...}}``.
Any failure exits non-zero before the last line; so does a machine without
a GPU. Run from the repository root: ``python3 chip_smoke.py``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

N_ITEMS = 12101
INPUT_DIM = 768
BATCH = 256
N_HIST = 20
BEAMS = 32
SEED = 0

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
FP32_FLOP_PER_S = 67e12     # H100 SXM fp32, outside the tensor cores


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def wall_ms(fn, iters: int) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device visible")
        return 1

    from rqvae_tpu_torch.data.schemas import SeqBatch
    from rqvae_tpu_torch.evaluate import metrics
    from rqvae_tpu_torch.models import generation, quantize, retrieval, rqvae
    from rqvae_tpu_torch.ops import _cuda_build
    from rqvae_tpu_torch.ops.children_window import children_window, children_window_plain
    from rqvae_tpu_torch.ops.quantize_kernels import rq_tokenize, rq_tokenize_plain
    from rqvae_tpu_torch.tokenizer import semids
    from rqvae_tpu_torch.utils import amp

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off: torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False")
    dev = torch.device("cuda")

    # ---- build every kernel of the path from the checkout's sources ----
    t0 = time.perf_counter()
    logs = _cuda_build.build_all(["rq_tokenize", "children_window"])
    build_s = time.perf_counter() - t0
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "bytes stack" in line:
                log(f"ptxas {name}: {line.strip()}")
    log(f"kernel build: {build_s:.1f} s")

    # ---- seeded weights and data (set-up, not the main path) ----
    gen = torch.Generator().manual_seed(SEED)
    gdev = torch.Generator(device=dev).manual_seed(SEED)
    rq_cfg = rqvae.RqVaeConfig(input_dim=INPUT_DIM, embed_dim=32, hidden_dims=(512, 256, 128),
                               codebook_size=256, n_layers=3, n_cat_feats=0,
                               commitment_weight=0.25, codebook_mode="ROTATION_TRICK")
    rq_params = rqvae.init(gen, rq_cfg, device=dev)
    corpus = torch.randn((N_ITEMS, INPUT_DIM), generator=gdev, device=dev)
    # the encoder's last layer is scaled to give unit-RMS codes, and each
    # level's codebook is drawn N(0, 1) at its residual's RMS: U(0,1)
    # codebooks against an untrained encoder would put every item on one
    # code, and its raw ~1e-2 outputs leave distance gaps at fp32 rounding
    with torch.no_grad():
        res = rqvae.encode(rq_params, rq_cfg, corpus)
        scale = res.pow(2).mean().rsqrt()
        rq_params["encoder"][-1] *= scale
        res = res * scale
        for level in rq_params["layers"]:
            cb = torch.randn(level["codebook"].shape, generator=gdev, device=dev)
            level["codebook"] = cb * res.pow(2).mean().sqrt()
            res = res - level["codebook"][quantize.distances(res, level["codebook"]).argmin(-1)]
    dec_cfg = retrieval.RetrievalConfig(embedding_dim=128, attn_dim=512, dropout=0.3, num_heads=8,
                                        n_layers=8, num_embeddings=256, sem_id_dim=4,
                                        max_pos=N_HIST * 4, user_hash_buckets=2000,
                                        mlp_hidden_dim=1024)
    dec_params = amp.cast_floating(retrieval.init(gen, dec_cfg, device=dev), torch.bfloat16)
    hist = torch.randint(0, N_ITEMS, (BATCH, N_HIST), generator=gdev, device=dev, dtype=torch.int32)
    seq_batch = SeqBatch(
        user_ids=torch.arange(BATCH, device=dev, dtype=torch.int32) * 7919,
        ids=hist,
        ids_fut=torch.randint(0, N_ITEMS, (BATCH, 1), generator=gdev, device=dev, dtype=torch.int32),
        x=torch.zeros((BATCH, N_HIST, 1), device=dev),
        x_fut=torch.zeros((BATCH, 1, 1), device=dev),
        seq_mask=torch.ones((BATCH, N_HIST), dtype=torch.bool, device=dev),
    )
    torch.cuda.synchronize()

    # ---- the main path, counted ----
    rq_tokenize.launches = 0
    children_window.launches = 0
    t0 = time.perf_counter()
    index = semids.precompute_corpus_ids(rq_params, rq_cfg, corpus)
    tok = semids.tokenize_sequences(index, seq_batch)
    out = generation.generate_next_sem_ids(dec_params, dec_cfg, index, tok, k=BEAMS,
                                           n_candidates=256)
    counts = metrics.batch_hit_counts(tok.sem_ids_fut, out.sem_ids, ks=(1, 5, 10))
    torch.cuda.synchronize()
    first_run_ms = (time.perf_counter() - t0) * 1e3
    launches = {"rq_tokenize": rq_tokenize.launches, "children_window": children_window.launches}
    log(f"main path launches: {launches}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")
    log(f"index: n_distinct {index.n_distinct}, bases {index.bases}, "
        f"max duplicates {semids.max_duplicates(index)}")

    # ---- outputs are right ----
    check(tuple(out.sem_ids.shape) == (BATCH, BEAMS, 4), f"sem_ids shape {tuple(out.sem_ids.shape)}")
    check(bool(torch.isfinite(out.log_probas).all()), "non-finite log-probas")
    check(bool((out.log_probas[:, 1:] <= out.log_probas[:, :-1]).all()), "beams not score-sorted")
    live = out.log_probas > generation.INVALID_PENALTY / 2
    member = semids.exists_prefix(index, out.sem_ids)
    check(bool(member[live].all()), "an unpenalised beam is not a corpus item")
    log(f"beams: {int(live.sum())} of {live.numel()} unpenalised, all corpus items; "
        f"h@10 {float(counts['h@10_slice_:4'])}, ndcg@10 {float(counts['ndcg@10']):.4f}")

    # a small fp32 run on the GPU against the same run on the CPU (plain twins)
    small = 4
    params32 = amp.cast_floating(dec_params, torch.float32)
    tok_small = type(tok)(*(None if t is None else t[:small] for t in tok))
    gpu_small = generation.generate_next_sem_ids(params32, dec_cfg, index, tok_small, k=BEAMS,
                                                 n_candidates=256)
    cpu = torch.device("cpu")
    index_cpu = semids.CorpusIndex(index.cached_ids.to(cpu), index.sorted_keys.to(cpu),
                                   index.bases, index.codebook_size, index.n_distinct)
    cpu_small = generation.generate_next_sem_ids(
        _to_device(params32, cpu), dec_cfg, index_cpu,
        type(tok)(*(None if t is None else t.to(cpu) for t in tok_small)), k=BEAMS,
        n_candidates=256)
    lp_gpu, lp_cpu = gpu_small.log_probas.cpu(), cpu_small.log_probas
    small_err = float((lp_gpu - lp_cpu).abs().max())
    check(small_err < 1e-3, f"GPU vs CPU fp32 log-probas differ by {small_err}")
    gap = torch.full_like(lp_cpu, float("inf"))
    gap[:, 1:] = lp_cpu[:, :-1] - lp_cpu[:, 1:]
    gap[:, :-1] = torch.minimum(gap[:, :-1], lp_cpu[:, :-1] - lp_cpu[:, 1:])
    clear = gap > 1e-3  # beams whose order cannot flip within the tolerance
    check(bool((gpu_small.sem_ids.cpu() == cpu_small.sem_ids).all(-1)[clear].all()),
          "GPU and CPU beams differ")
    log(f"4-user fp32 GPU vs CPU: max |dlogp| {small_err:.2e}, {int(clear.sum())} beams compared")

    # ---- each kernel against its plain twin, on the main path's inputs ----
    kernels = []
    cbs = rqvae.effective_codebooks(rq_params, rq_cfg).float().contiguous()
    chunks = [rqvae.encode(rq_params, rq_cfg, corpus[i:i + 4096]).float().contiguous()
              for i in range(0, N_ITEMS, 4096)]
    n_ties = n_diff = 0
    rq_err = 0.0
    for z in chunks:
        k_out = rq_tokenize(z, cbs, commitment_weight=rq_cfg.commitment_weight)
        p_out = rq_tokenize_plain(z, cbs, commitment_weight=rq_cfg.commitment_weight)
        differ = (k_out.sem_ids != p_out.sem_ids).any(-1)
        near = _near_ties(z, cbs, p_out.sem_ids)
        check(not bool((differ & ~near).any()), "rq_tokenize ids differ off near-ties")
        n_ties += int(near.sum())
        n_diff += int(differ.sum())
        same = ~differ
        for a, b in zip(k_out[1:], p_out[1:]):
            check(torch.allclose(a[same], b[same], rtol=1e-5, atol=1e-5),
                  "rq_tokenize sums / residual / loss differ from the plain version")
            rq_err = max(rq_err, float((a[same] - b[same]).abs().max()))
    log(f"rq_tokenize vs plain: {n_diff} rows with other ids, {n_ties} near-tie rows, "
        f"max |err| {rq_err:.2e}")
    z0 = chunks[0]
    b0, d0 = z0.shape
    n_lv, n_code = cbs.shape[:2]
    rq_bytes = 4 * (b0 * d0 + n_lv * n_code * d0 + b0 * n_lv + 2 * b0 * d0 + b0)
    rq_flops = 2 * b0 * n_lv * n_code * d0
    rq_bound = max(rq_bytes / HBM_BYTES_PER_S, rq_flops / FP32_FLOP_PER_S) * 1e3
    kernels.append(dict(
        name="rq_tokenize", route="cuda", source="rqvae_tpu_torch/csrc/rq_tokenize.cu",
        replaces="rqvae_tpu/ops/quantize_pallas.py:48",
        launches=launches["rq_tokenize"], max_abs_err=rq_err,
        ms=cuda_ms(lambda: rq_tokenize(z0, cbs), 50),
        plain_ms=cuda_ms(lambda: rq_tokenize_plain(z0, cbs), 50),
        bound_ms=rq_bound,
        bound_by="operations" if rq_flops / FP32_FLOP_PER_S > rq_bytes / HBM_BYTES_PER_S else "bytes",
        library_ms=None,
    ))

    # the beam search's own children_window operands: rerun it (same weights
    # and inputs) with the call recorded
    k_tok = index.codebook_size
    cw_inputs = []

    def record(*args, **kwargs):
        cw_inputs.append(args)
        return children_window(*args, **kwargs)

    semids.children_window = record
    try:
        again = generation.generate_next_sem_ids(dec_params, dec_cfg, index, tok, k=BEAMS,
                                                 n_candidates=256)
    finally:
        semids.children_window = children_window
    log(f"rerun beams equal to the main path's: {bool((again.sem_ids == out.sem_ids).all())}")
    check([a[1].shape[0] for a in cw_inputs] == [1] + [BATCH * BEAMS] * 3,
          f"children_window rows per step {[a[1].shape[0] for a in cw_inputs]}")
    cw_err = 0
    for args in cw_inputs:
        k_out = children_window(*args, window=k_tok, k_tokens=k_tok)
        p_out = children_window_plain(*args, window=k_tok, k_tokens=k_tok)
        cw_err = max(cw_err, int((k_out - p_out).abs().max()))
    check(cw_err == 0, f"children_window differs from the plain version by {cw_err}")
    log("children_window vs plain: identical at levels 0..3")
    big = cw_inputs[1:]
    n_table = index.n_items
    rows = big[0][1].shape[0]
    cw_bytes = 8 * n_table + rows * (4 + 4 + 8) + 4 * rows * k_tok
    kernels.append(dict(
        name="children_window", route="cuda", source="rqvae_tpu_torch/csrc/children_window.cu",
        replaces="rqvae_tpu/ops/children_window.py:33",
        launches=launches["children_window"], max_abs_err=float(cw_err),
        ms=sum(cuda_ms(lambda a=a: children_window(*a, window=k_tok, k_tokens=k_tok), 100)
               for a in big) / len(big),
        plain_ms=sum(cuda_ms(lambda a=a: children_window_plain(*a, window=k_tok, k_tokens=k_tok),
                             100) for a in big) / len(big),
        bound_ms=cw_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes", library_ms=None,
    ))

    # ---- serving path times ----
    tok_ms = wall_ms(lambda: semids.precompute_corpus_ids(rq_params, rq_cfg, corpus), 5)
    gen_ms = wall_ms(lambda: generation.generate_next_sem_ids(
        dec_params, dec_cfg, index, tok, k=BEAMS, n_candidates=256), 10)
    serving = dict(corpus_tokenize_ms=tok_ms, generate_ms=gen_ms,
                   queries_per_s=BATCH / (gen_ms / 1e3), first_main_path_ms=first_run_ms,
                   build_s=build_s, batch=BATCH, beams=BEAMS, corpus_items=N_ITEMS,
                   generate_profile=_profile(lambda: generation.generate_next_sem_ids(
                       dec_params, dec_cfg, index, tok, k=BEAMS, n_candidates=256)))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"serving": serving}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _profile(fn, top: int = 8) -> dict:
    """One traced call of ``fn``: wall time, summed device time (the device's
    busy share of the wall time) and the ops with the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device-side events only (kernels, copies): CPU ops would count them twice
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA), key=dev_us, reverse=True)
    busy_us = sum(dev_us(e) for e in events)
    return dict(wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
                device_idle_share=1.0 - busy_us / wall_us if busy_us else None,
                top_device_ops=[[e.key[:90], dev_us(e) / 1e3, e.count] for e in events[:top]])


def _to_device(tree, device):
    from rqvae_tpu_torch.utils.tree import tree_map

    return tree_map(lambda t: t.to(device), tree)


def _near_ties(z, cbs, ids, rel: float = 1e-5):
    """Rows where, along the ``ids`` residual chain, the two smallest
    distances (float64) of some level differ by less than ``rel``."""
    import torch

    res = z.double()
    near = torch.zeros(z.shape[0], dtype=torch.bool, device=z.device)
    for level, cb in enumerate(cbs.double()):
        dist = torch.cdist(res, cb) ** 2
        two = torch.topk(dist, 2, dim=1, largest=False).values
        near |= (two[:, 1] - two[:, 0]) < rel * torch.clamp(two[:, 0].abs(), min=1.0)
        res = res - cb[ids[:, level].long()]
    return near


if __name__ == "__main__":
    sys.exit(main())
