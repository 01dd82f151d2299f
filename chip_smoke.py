#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: Amazon serving, ML-32M
decoder training and ML-32M serving, packed long-context decoder training,
stage-1 RQ-VAE training, then Amazon decoder training through
``train_decoder.train`` over the stage-1 checkpoint.

Drives ``rqvae_tpu_torch`` end to end at the shipped widths, with random
weights made from a seed and seeded synthetic data:

  1. print the card's name and power limit (nvidia-smi);
  2. build the nine CUDA kernels from ``rqvae_tpu_torch/csrc`` (one nvcc
     per source, in parallel) and print the build time;
  3. Amazon serving main path: tokenize the 12,101 x 768 corpus with the
     RQ-VAE (``precompute_corpus_ids``: 3 x 256 x 32 codebooks, fp32,
     4,096-row chunks), tokenize 256 users x 20 history items, run
     constrained beam search (``generate_next_sem_ids``: k = 32, exhaustive
     candidates, bf16 decoder weights: 4 + 4 layers, width 512, 8 heads) and
     count h@k / NDCG; check that rq_tokenize and children_window were
     launched (counts zeroed just before, read just after);
  4. compare those two kernels with their plain PyTorch twins on the main
     path's own inputs; check the beams (corpus members, finite, sorted) and
     a 4-user fp32 GPU run against the same run on the CPU;
  5. ML-32M train step, the ``bench.py --profile ml32m`` shape: batch 256,
     200-item histories cut by the crop-length distribution (801 encoder
     tokens), an 84,432-item corpus of random 3-level tuples plus the dedup
     column, 4 + 4 layers, width 512, 8 heads, fp32 master params, bf16
     compute, ``adamw(3e-4, 0.035)``, ``make_train_step(accum=1)``: 3 warm-up
     and 10 timed steps; the flash forward and backward kernels must run 4
     times each per step (the encoder's self-attention);
  6. the same batch through ``bucket_slices`` / ``make_bucketed_fns`` with
     2 buckets (``configs/decoder_ml32m.json``): groups padded below 256
     tokens go dense, as in JAX;
  7. each flash kernel against its plain twin on one encoder layer's own
     operands, recorded in a rerun of the step (first 16 batch rows, N =
     801; the upstream gradient scaled to unit RMS): bf16 to 2e-2, fp32 to
     1e-4, plus a causal case, a random key mask with fully masked rows
     (their outputs and every gradient of their batch rows exactly 0), a
     mask whose first two key tiles are all masked, the operands as
     views whose rows are not 16-byte aligned (the CUDA-core path: the C
     dispatcher's path rule must give no dq accumulator there and one for
     the aligned bf16 operands) and q cut to its first 705 rows (the last
     128-row block of the bf16 forward holds 65 rows, one of them in its
     second warpgroup); in every case the forward's row statistics against
     the twin's: m to 1e-5 of its max-abs, inv to 1e-3 relative (bf16) or
     1e-5 (fp32), and m = -1e30, inv = 0 exactly on rows with no allowed
     key;
  8. a 2-user fp32 train step (dropout 0) on the GPU against the CPU: loss
     to 1e-4 relative, every gradient leaf to 1e-3 of its max-abs;
  9. ML-32M serving: 64 users x 801 tokens against the 84,432-item index,
     k = 32, 256 candidates, through the flash forward kernel;
 10. time every kernel, its twin and the library call beside it (the flash
     bound counts the (q, k) pairs with a valid key and the K / V bytes of
     the valid keys, the dense count and the exp floor beside it); dense
     ``sdpa`` against ``flash_attention`` at N = 801 and 81; trace one
     corpus tokenization, one Amazon beam search and one ML-32M train step
     with torch.profiler;
 11. stage-1 flagship: ``train_rqvae.train`` on ``configs/rqvae_amazon.json``
     (768 -> 512 -> 256 -> 128 -> 32, 3 x 256 codebooks, rotation trick,
     batch 64, fp32) over 12,101 synthetic items (seed 0): k-means priming,
     400 steps in device-resident chunks of 8, eval and a checkpoint at the
     end; the loss must fall, the eval must tokenize through rq_tokenize and
     the plain route must not launch rq_quantize_train (volume 8,192);
 12. stage-1 stretch (``bench.py``'s ``rqvae_stretch``: embed 64, 4 x 2048
     codebooks, batch 1024, bf16 compute, 16 steps a chunk) on a 12,101 x 768
     N(0, 1) corpus after k-means priming: rq_quantize_train must launch once
     per step; ``id_diversity_metrics`` tokenizes the corpus through the
     K-tiled rq_tokenize at 4 x 2048 x 64; one chunk is traced;
 13. rq_quantize_train against its twin on the stretch step's own encoder
     output and codebooks (ids equal off near-ties, values to 1e-5), its
     gradients (STE and rotation trick) against the plain per-level
     ``quantize.apply`` chain to 1e-4 of each leaf's max-abs; the K-tiled
     rq_tokenize against its twin at 4 x 2048 x 64 on the corpus chunks the
     diversity metrics tokenized (their own ids) and on the step's rows; both
     quantizer kernels at four odd shapes (part-filled code tiles, D = 3 and
     128);
 14. two fp32 stage-1 steps at the Amazon widths, batch 64, GPU against CPU,
     through both quantizer routes: loss to 1e-5 relative, gradient leaves to
     1e-4 of their max-abs;
 15. the new kernel's times beside its twin's and its bound; the step time of
     the fused and the plain route at both shapes (the module constant
     ``FUSED_TRAIN_MIN_CODEBOOK_VOLUME`` forced each way);
 16. packed long-context training (``bench.py --profile ml32m_packed``,
     run before the stage-1 phases): the ML-32M widths and corpus, a
     ``SeqDataset`` of 4,096 users with full 200-item histories, a
     ``SequencePacker`` (numpy generator seed 0) of 96 rows x 8 slots x 200
     items (808 encoder tokens, 40 decoder tokens) past 3 warm-up batches,
     then a cycle of 8 batches through ``make_packed_step`` (bf16 compute,
     fp32 AdamW, dropout 0.3): 3 warm-up and 10 timed steps; the span
     forward and backward kernels must launch 4 times each per step (the
     encoder's self-attention) and the flat flash kernels never;
 17. each span kernel against its plain twin on encoder layer 0's own
     operands, recorded in a rerun of the step (first 16 rows, N = 808, the
     upstream gradient scaled to unit RMS), bf16 to 2e-2 and fp32 to 1e-4,
     plus rows that attend nothing (their output and dq must be exactly 0),
     rows with only the extra column, windows across 64-key tile edges, extra
     columns outside the window and Nq = 777, the row statistics held as in
     phase 7; the span library's C path rule must give the aligned bf16
     operands a dq accumulator;
 18. a 2-row fp32 packed step (dropout 0) on the GPU against the CPU: loss
     to 1e-4 relative, every gradient leaf to 1e-3 of its max-abs;
 19. both span kernels timed on phase 16's operands beside their twins and
     ``F.scaled_dot_product_attention`` under the span mask as a (B, 1, Nq,
     Nk) additive bias; the bound counts the allowed (q, k) pairs and the
     K / V bytes of the keys some row attends (the dense count beside it);
     one packed step traced;
 20. the Amazon decoder (run after stage 1), ``RQVAE_TPU_SHORT_FLASH=1``:
     ``train_decoder.train`` on ``configs/decoder_amazon.json`` (4 + 4
     layers, width 512, 8 heads, embedding 128, K = 256, batch 256,
     dropout 0.3, bf16 compute over fp32 AdamW) over 12,101 synthetic
     items and 22,363 synthetic users (Amazon Beauty's counts), the frozen
     RQ-VAE restored from phase 11's checkpoint, 300 steps, eval loss and
     constrained-beam-search eval (2 batches) and a checkpoint at the end,
     then a resumed call of 20 more steps; the loss must fall, every
     attention call must take flash_attention_small (12 forward and 12
     backward launches a step) and the flat flash kernels never;
 21. both short kernels against their twins on layer 0's operands of the
     three attention kinds (81 x 81 encoder, causal 5 x 5 decoder, 5 x 81
     cross), recorded in the resumed call's first step (unit-RMS upstream
     gradient), and at the decode step's 1 x 1..4, the 32 x 81 beam-folded
     cross, 241 x 241 (the ML-32M short bucket), a causal 255 x 255 at
     Dh = 128 and rows with no valid key (exactly 0): bf16 to 2e-2, fp32 to
     1e-4;
 22. a 2-user fp32 Amazon step with the switch on, GPU against CPU;
 23. the switch off / on / on / off in turns: the Amazon train step
     (batch 256) and beam search (256 users, k = 32); the short kernels'
     times on the encoder operands beside their twins,
     ``F.scaled_dot_product_attention`` with the mask as an additive bias,
     the dense ``sdpa`` and the bound; one traced step;
 24. the width rule of the kernel routes (run after phase 4): ``attend`` at
     Dh = 256 on a span, a short (switch on) and a flat shape, and the
     RQ-VAE's two quantizer routes at embed_dim = 256 (codebook volume
     65,536), each on the card against the same call on the CPU (values
     and gradients to 1e-5 of their max-abs; ids equal off near-ties; the
     training loss to 1e-5 relative and gradient leaves to 1e-4 of their
     max-abs): shapes wider than the kernels take go the dense and plain
     routes, and no kernel wrapper launches.

TF32 is switched off for matmuls and cuDNN, so fp32 work runs in fp32.
``RQVAE_TPU_SHORT_FLASH`` is unset for phases 1-19, so they take
``attend``'s default routes.

Prints the nvidia-smi line, a ``{"serving": {...}}`` line, a
``{"train": {...}}`` line (the packed step under its ``packed`` key, the
Amazon decoder under ``amazon``), a ``{"train_rqvae": {...}}`` line, a
``{"wide": {...}}`` line (phase 24), the nvidia-smi line again, a
``{"kernels": [...]}`` line (nine entries) and, last, ``{"ok": true,
"device": {...}}``.
Any failure exits non-zero before the last line; so does a machine without
a GPU. Run from the repository root: ``python3 chip_smoke.py``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys
import tempfile
import time

N_ITEMS = 12101
INPUT_DIM = 768
BATCH = 256
N_HIST = 20
BEAMS = 32
SEED = 0

ML_BATCH = 256
ML_HIST = 200
ML_ITEMS = 84432
ML_GEN_BATCH = 64
PACK_ROWS = 96          # bench.py's ml32m_packed: 96 rows x 8 slots x ML_HIST items
PACK_SLOTS = 8
PACK_USERS = 4096

RQ_ITERS = 400          # stage-1 flagship steps
STRETCH_BATCH = 1024    # bench.py's rqvae_stretch: 4 x 2048 codebooks, embed 64
STRETCH_LEVELS = 4
STRETCH_K = 2048
STRETCH_EMBED = 64
STRETCH_STEPS = 16      # steps per device-resident chunk
STRETCH_CHUNKS = 3      # timed chunks

AMAZON_USERS = 22363    # Amazon Beauty's users (TIGER, Table 1); its items are N_ITEMS
AMAZON_ITERS = 300      # decoder steps through train_decoder.train (the config: 200,000)
AMAZON_RESUME_ITERS = 20
AMAZON_EVAL_BATCHES = 2
SHORT_FLASH_ENV = "RQVAE_TPU_SHORT_FLASH"   # attend's short-route switch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
FP32_FLOP_PER_S = 67e12     # H100 SXM fp32, outside the tensor cores
BF16_FLOP_PER_S = 989e12    # H100 SXM bf16 tensor cores, dense
EXP_PER_S = 132 * 16 * 1.98e9   # H100 SXM ex2 on the special-function units, 1.98 GHz boost


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

    # every phase before the Amazon decoder's runs attend's default routes
    os.environ.pop(SHORT_FLASH_ENV, None)
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
    logs = _cuda_build.build_all(["rq_tokenize", "children_window", "flash_attention_fwd",
                                  "flash_attention_bwd", "flash_attention_spans_fwd",
                                  "flash_attention_spans_bwd", "rq_quantize_train",
                                  "flash_attention_small_fwd", "flash_attention_small_bwd"])
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
    n_diff = n_ties = n_ties_d0 = 0
    rq_err = 0.0
    for z in chunks:
        k_out = rq_tokenize(z, cbs, commitment_weight=rq_cfg.commitment_weight)
        held = _hold_rq_tokenize(z, cbs, rq_cfg.commitment_weight, k_out)
        n_diff, n_ties, n_ties_d0 = n_diff + held[0], n_ties + held[1], n_ties_d0 + held[2]
        rq_err = max(rq_err, held[3])
    log(f"rq_tokenize vs plain: {n_diff} rows with other ids, near-tie rows {n_ties} "
        f"(gap < 1e-5 of ||r||^2 + ||cb||^2) / {n_ties_d0} (gap < 1e-5 of max(d0, 1)), "
        f"max |err| {rq_err:.2e}")
    rq_check = dict(rows=N_ITEMS, id_rows_differ=n_diff, near_tie_rows_terms=n_ties,
                    near_tie_rows_d0=n_ties_d0, max_abs_err=rq_err)
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
                   rq_tokenize_check=rq_check,
                   corpus_tokenize_profile=_profile(lambda: semids.precompute_corpus_ids(
                       rq_params, rq_cfg, corpus)),
                   generate_profile=_profile(lambda: generation.generate_next_sem_ids(
                       dec_params, dec_cfg, index, tok, k=BEAMS, n_candidates=256)))
    del rq_params, corpus, index, dec_params, params32, chunks, cw_inputs, big, out, again

    # ---- phase 24: the width rule of the kernel routes ----
    wide = _wide(dev)

    # ---- ML-32M: decoder training, then long-context serving ----
    train, ml_serving, flash_kernels = _ml32m(dev)
    kernels += flash_kernels
    serving["ml32m"] = ml_serving
    torch.cuda.empty_cache()

    # ---- packed long-context decoder training ----
    train["packed"], span_kernels = _packed(dev)
    kernels += span_kernels
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as work:
        # ---- stage-1 RQ-VAE training, flagship and stretch ----
        train_rqvae, stage1_kernels, rq_ckpt = _stage1(dev, work)
        kernels += stage1_kernels
        torch.cuda.empty_cache()

        # ---- the Amazon decoder through train(), over the flagship's checkpoint ----
        train["amazon"], small_kernels = _amazon_decoder(dev, rq_ckpt, work)
        kernels += small_kernels
    print(json.dumps({"serving": serving}), flush=True)
    print(json.dumps({"train": train}), flush=True)
    print(json.dumps({"train_rqvae": train_rqvae}), flush=True)
    print(json.dumps({"wide": wide}), flush=True)
    # the card and the kernels once more, last, where a capture of the
    # output's tail keeps them
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _wide(dev):
    """Phase 24: shapes wider than the kernels take go the plain routes.
    ``attend`` at Dh = 256 on a span, a short (switch on) and a flat shape,
    and the RQ-VAE's two quantizer routes at embed_dim = 256 (volume 65,536:
    the fused training route but for the width rule), each on the card
    against the same call on the CPU; no kernel wrapper may launch."""
    import numpy as np
    import torch

    from rqvae_tpu_torch.models import quantize, rqvae
    from rqvae_tpu_torch.ops import attention as attn_ops
    from rqvae_tpu_torch.ops import flash_attention as fa
    from rqvae_tpu_torch.ops import quantize_kernels as qk
    from rqvae_tpu_torch.utils.tree import tree_leaves, tree_map

    cpu = torch.device("cpu")
    rng = np.random.RandomState(SEED + 24)
    wrappers = (fa.flash_attention_fwd, fa.flash_attention_bwd, fa.flash_attention_spans_fwd,
                fa.flash_attention_spans_bwd, fa.flash_attention_small_fwd,
                fa.flash_attention_small_bwd, qk.rq_tokenize, qk.rq_quantize_train)
    for w in wrappers:
        w.launches = 0
    out = {}

    def rel_err(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-12)

    # attend: values and gradients, fp32, 1e-5 of each tensor's max-abs
    b, h, dh = 2, 2, 256
    for case, n in (("span", 300), ("short", 81), ("flat", 300)):
        q, k, v, gr = (rng.randn(b, n, h, dh).astype(np.float32) for _ in range(4))
        lo = rng.randint(0, n - 40, (b, n))
        spans = (lo, lo + rng.randint(0, 40, (b, n)), rng.randint(-1, n, (b, n)))
        k_mask = np.arange(n)[None, :] < np.array([n, n - 30])[:, None]
        runs = []
        for device in (dev, cpu):
            t = [torch.from_numpy(x).to(device).requires_grad_(True) for x in (q, k, v)]
            if case == "span":
                kw = dict(q_spans=tuple(torch.from_numpy(a.astype(np.int32)).to(device)
                                        for a in spans))
            else:
                kw = dict(k_mask=torch.from_numpy(k_mask).to(device), causal=case == "short")
            if case == "short":
                os.environ[SHORT_FLASH_ENV] = "1"
            try:
                o = attn_ops.attend(*t, **kw)
            finally:
                os.environ.pop(SHORT_FLASH_ENV, None)
            grads = torch.autograd.grad(o, t, torch.from_numpy(gr).to(device))
            runs.append([x.detach().cpu() for x in (o, *grads)])
        errs = [rel_err(a, b_) for a, b_ in zip(*runs)]
        check(max(errs) <= 1e-5, f"attend at Dh = {dh}, {case}: GPU vs CPU {errs}")
        out[f"attend_{case}"] = dict(n=n, dh=dh, rel_err_out_dq_dk_dv=errs)

    # the quantizer routes at embed_dim 256
    cfg = rqvae.RqVaeConfig(input_dim=INPUT_DIM, embed_dim=256, hidden_dims=(512,),
                            codebook_size=256, n_layers=3, n_cat_feats=0,
                            codebook_mode=quantize.QuantizeForwardMode.ROTATION_TRICK)
    check(cfg.codebook_size * cfg.embed_dim >= rqvae.FUSED_TRAIN_MIN_CODEBOOK_VOLUME,
          "phase 24's config must reach the fused route's volume")
    params = rqvae.init(torch.Generator().manual_seed(SEED + 24), cfg, device=cpu)
    x = torch.from_numpy(rng.randn(1024, INPUT_DIM).astype(np.float32))
    with torch.no_grad():
        z = rqvae.encode(params, cfg, x).float()
        cbs = rqvae.effective_codebooks(params, cfg).float()
    ids_cpu = rqvae.encode_and_tokenize(params, cfg, x)
    ids_gpu = rqvae.encode_and_tokenize(_to_device(params, dev), cfg, x.to(dev)).cpu()
    ties = _near_ties(z, cbs, ids_cpu)
    differ = (ids_gpu != ids_cpu).any(dim=1)
    check(not bool((differ & ~ties).any()),
          f"encode_and_tokenize at D = 256: {int((differ & ~ties).sum())} rows differ off near-ties")
    clean = x[~_near_ties(z, cbs, ids_cpu, rel=1e-4)][:256]
    runs = []
    for device in (dev, cpu):
        p = tree_map(lambda t: t.detach().to(device, copy=True).requires_grad_(True), params)
        loss = rqvae.forward(p, cfg, clean.to(device), gumbel_t=0.2, training=True).loss
        grads = torch.autograd.grad(loss, tree_leaves(p), allow_unused=True)
        runs.append((float(loss.detach()), [None if g_ is None else g_.cpu() for g_ in grads]))
    (lg, gg), (lc, gc) = runs
    loss_rel = abs(lg - lc) / abs(lc)
    leaf_rel = max(rel_err(a, b_) for a, b_ in zip(gg, gc) if b_ is not None)
    check(loss_rel <= 1e-5 and leaf_rel <= 1e-4,
          f"training forward at D = 256: GPU vs CPU loss {loss_rel}, worst leaf {leaf_rel}")
    launches = {w.__name__: w.launches for w in wrappers}
    check(not any(launches.values()), f"a kernel launched on a shape wider than it takes: {launches}")
    out["quantizer_d256"] = dict(rows=int(x.shape[0]), differing_rows=int(differ.sum()),
                                 near_tie_rows=int(ties.sum()), train_rows=int(clean.shape[0]),
                                 loss_rel_err=loss_rel, worst_leaf_rel_err=leaf_rel)
    out["launches"] = launches
    log(f"wide shapes take the plain routes: {out}")
    return out


def _crop_lengths(rng, count: int, n_hist: int):
    """History lengths of the reference's random-crop subsample applied to
    full n_hist-item windows: the ML-32M training length distribution
    (``bench.py --profile ml32m`` draws them the same way)."""
    import numpy as np

    seqlen = n_hist + 1
    start = rng.randint(0, seqlen - 2, (count,))
    end = start + rng.randint(3, n_hist + 2, (count,))
    return np.minimum(end, seqlen) - start - 1


def _seq_batch(ids, ids_fut, user_ids, dev):
    """A SeqBatch from numpy item ids (-1 padded); features are unused by
    decoder training, so they are placeholders."""
    import torch

    from rqvae_tpu_torch.data.schemas import SeqBatch

    ids_t = torch.from_numpy(ids).to(dev)
    return SeqBatch(user_ids=torch.from_numpy(user_ids).to(dev), ids=ids_t,
                    ids_fut=torch.from_numpy(ids_fut).to(dev),
                    x=torch.zeros(ids.shape + (1,), device=dev),
                    x_fut=torch.zeros(ids_fut.shape + (1,), device=dev), seq_mask=ids_t >= 0)


def _ml32m_config():
    """The ML-32M decoder at ``bench.py``'s widths: 4 + 4 layers, width 512,
    8 heads (Dh = 64), embedding 128, MLP 1024, K = 256, dropout 0.3."""
    from rqvae_tpu_torch.models import retrieval

    return retrieval.RetrievalConfig(embedding_dim=128, attn_dim=512, dropout=0.3, num_heads=8,
                                     n_layers=8, num_embeddings=256, sem_id_dim=4,
                                     max_pos=ML_HIST * 4)


def _ml32m_index(rng, dev):
    """The ML_ITEMS-item corpus of random 3-level tuples (drawn from the
    numpy ``rng``) plus the dedup column, indexed."""
    import numpy as np
    import torch

    from rqvae_tpu_torch.tokenizer import semids

    base = torch.from_numpy(rng.randint(0, 256, (ML_ITEMS, 3)).astype(np.int32)).to(dev)
    cached = torch.cat([base, semids.dedup_column(base, 256)[:, None]], dim=1)
    return semids.build_index(cached, codebook_size=256)


def _ml32m(dev):
    """Phases 5-10: ML-32M decoder training (flat and bucketed), the flash
    kernels against their twins, GPU vs CPU, ML-32M serving and the
    timings. Returns (train dict, serving dict, kernel entries)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from rqvae_tpu_torch.data.schemas import TokenizedSeqBatch
    from rqvae_tpu_torch.models import generation, retrieval
    from rqvae_tpu_torch.ops import attention as attn_ops
    from rqvae_tpu_torch.ops import flash_attention as fa
    from rqvae_tpu_torch.ops.children_window import children_window
    from rqvae_tpu_torch.tokenizer import semids
    from rqvae_tpu_torch.train import optim
    from rqvae_tpu_torch.train import train_decoder as td
    from rqvae_tpu_torch.utils import amp
    from rqvae_tpu_torch.utils.tree import tree_leaves, tree_map

    cfg = _ml32m_config()
    rng = np.random.RandomState(SEED)
    index = _ml32m_index(rng, dev)
    ids = rng.randint(0, ML_ITEMS, (ML_BATCH, ML_HIST)).astype(np.int32)
    lengths = _crop_lengths(rng, ML_BATCH, ML_HIST)
    mask = np.arange(ML_HIST)[None, :] < lengths[:, None]
    ids = np.where(mask, ids, -1)
    ids_fut = rng.randint(0, ML_ITEMS, (ML_BATCH, 1)).astype(np.int32)
    users = np.arange(ML_BATCH, dtype=np.int32)
    flat = _seq_batch(ids, ids_fut, users, dev)
    flat = type(flat)(*(t[None] for t in flat))   # the step's leading accum axis
    params = retrieval.init(torch.Generator().manual_seed(SEED), cfg, device=dev)
    opt = optim.adamw(3e-4, 0.035)
    opt_state = opt.init(params)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    step = td.make_train_step(cfg, opt, index, 1, torch.bfloat16, 4)
    log(f"ML-32M batch: {ML_BATCH} rows, mean history {float(lengths.mean()):.1f} items, "
        f"{ML_HIST * 4 + 1} encoder tokens padded; corpus {ML_ITEMS} items, "
        f"{index.n_distinct[-1]} distinct ids, max dedup {semids.max_duplicates(index)}")

    # ---- phase 5: flat train step, the main path of this slice, counted ----
    losses = []
    for _ in range(3):
        params, opt_state, m = step(params, opt_state, flat, gen)
        losses.append(float(m["total_loss"]))
    torch.cuda.synchronize()
    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_bwd.launches = 0
    torch.cuda.reset_peak_memory_stats()
    n_steps = 10
    t0 = time.perf_counter()
    for _ in range(n_steps):
        params, opt_state, m = step(params, opt_state, flat, gen)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    losses.append(float(m["total_loss"]))
    launches = {"flash_attention_fwd": fa.flash_attention_fwd.launches,
                "flash_attention_bwd": fa.flash_attention_bwd.launches}
    log(f"ML-32M flat step: {step_ms:.1f} ms, losses {losses}, launches {launches}")
    check(all(math.isfinite(x) for x in losses), f"non-finite training loss {losses}")
    for name, n in launches.items():
        check(n == 4 * n_steps, f"{name}: {n} launches in {n_steps} steps, expected 4 per step")
    flat_out = dict(train_step_ms=step_ms, train_examples_per_s=ML_BATCH / (step_ms / 1e3),
                    steps_timed=n_steps, losses=losses, batch=ML_BATCH,
                    encoder_tokens=ML_HIST * 4 + 1,
                    flash_fwd_per_step=launches["flash_attention_fwd"] / n_steps,
                    flash_bwd_per_step=launches["flash_attention_bwd"] / n_steps,
                    peak_memory_gb=torch.cuda.max_memory_allocated() / 2**30)

    # ---- phase 6: the same batch, length-bucketed (2 groups) ----
    grad_accum, apply = td.make_bucketed_fns(cfg, opt, index, torch.bfloat16, 4)
    groups = []
    for rows, length in td.bucket_slices(mask.sum(axis=1), 2):
        groups.append((_seq_batch(ids[rows, :length], ids_fut[rows], rows.astype(np.int32), dev),
                       len(rows), length))

    def bucketed_step(params, opt_state, record=None):
        grads = tree_map(torch.zeros_like, params)
        loss = torch.zeros((), device=dev)
        loss_d = torch.zeros((4,), device=dev)
        for batch, _, _ in groups:
            before = fa.flash_attention_fwd.launches
            grads, loss, loss_d = grad_accum(params, grads, loss, loss_d, batch, gen, 0.5)
            if record is not None:
                record.append(fa.flash_attention_fwd.launches - before)
        params, opt_state = apply(params, opt_state, grads)
        return params, opt_state, loss

    per_group = []
    for _ in range(3):
        params, opt_state, loss = bucketed_step(params, opt_state)
    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_bwd.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_steps):
        params, opt_state, loss = bucketed_step(params, opt_state, per_group if i == 0 else None)
    torch.cuda.synchronize()
    bucket_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    check(math.isfinite(float(loss)), f"non-finite bucketed loss {float(loss)}")
    group_info = []
    for (_, rows, length), n_fwd in zip(groups, per_group):
        tokens = 4 * length + 1
        group_info.append(dict(rows=rows, items=length, tokens=tokens, flash=n_fwd > 0))
        check((n_fwd == 4) == (tokens >= attn_ops.FLASH_MIN_LEN),
              f"group of {tokens} tokens: {n_fwd} flash launches")
    log(f"ML-32M bucketed step: {bucket_ms:.1f} ms, groups {group_info}")
    bucketed_out = dict(train_step_ms=bucket_ms, train_examples_per_s=ML_BATCH / (bucket_ms / 1e3),
                        loss=float(loss), groups=group_info,
                        flash_fwd_launches=fa.flash_attention_fwd.launches,
                        flash_bwd_launches=fa.flash_attention_bwd.launches)

    # ---- phase 7: each flash kernel against its twin, on the step's operands ----
    rec = {}
    real_flash = attn_ops.flash_attention

    def record(q, k, v, *, k_mask=None, causal=False):
        out = real_flash(q, k, v, k_mask=k_mask, causal=causal)
        if not rec:  # the first call of a step: encoder layer 0
            rec.update(q=q.detach(), k=k.detach(), v=v.detach(), k_mask=k_mask)
            out.register_hook(lambda g: rec.__setitem__("g", g.detach()))
        return out

    attn_ops.flash_attention = record
    try:
        params, opt_state, _ = step(params, opt_state, flat, gen)
    finally:
        attn_ops.flash_attention = real_flash
    torch.cuda.synchronize()
    check(set(rec) == {"q", "k", "v", "k_mask", "g"}, f"recorded {sorted(rec)}")
    q, k, v, km, g = rec["q"], rec["k"], rec["v"], rec["k_mask"], rec["g"]
    log(f"recorded layer-0 operands: q {tuple(q.shape)} {q.dtype} strides {q.stride()}, "
        f"g rms {float(g.float().pow(2).mean().sqrt()):.3e}")
    small = 16
    qs, ks, vs, kms = q[:small], k[:small], v[:small], km[:small]
    gs = g[:small].float()
    gs = (gs / gs.pow(2).mean().sqrt()).to(g.dtype)
    holes = torch.rand(km[:small].shape, device=dev, generator=gen) < 0.5
    holes[:2] = False   # two rows with no valid key
    late = torch.zeros_like(kms)
    late[:, 130:] = True  # the first two 64-key tiles all masked, valid keys after
    def unaligned(t):  # the same values in a view whose rows are not 16-byte aligned
        buf = torch.empty(t.shape[:-1] + (t.shape[-1] + 1,), dtype=t.dtype, device=t.device)
        buf[..., 1:] = t
        return buf[..., 1:]

    checks, errs = [], {"fwd": 0.0, "bwd": 0.0}
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        for case, case_mask, causal in (("train", kms, False), ("causal", kms, True),
                                        ("holes", holes, False), ("late", late, False),
                                        ("unaligned", kms, False), ("nq_705", kms, False)):
            a = [t.to(dtype) for t in (qs, ks, vs, gs)]
            if case == "unaligned":   # the CUDA-core path; the C rule gives no dq accumulator
                a = [unaligned(t) for t in a]
            if case == "nq_705":      # the last 128-row block: 65 rows, one in its second warpgroup
                a[0], a[3] = a[0][:, :, :705], a[3][:, :, :705]
            out, mm, inv = fa.flash_attention_fwd(*a[:3], k_mask=case_mask, causal=causal)
            ref, ref_m, ref_inv = fa._plain_fwd(
                *a[:3], fa._key_masker(fa.mask_bias(case_mask, small, a[1].shape[2], dev), causal))
            got = fa.flash_attention_bwd(*a, mm, inv, k_mask=case_mask, causal=causal)
            want = fa.flash_attention_bwd_plain(*a, k_mask=case_mask, causal=causal)
            torch.cuda.synchronize()
            row = {"dtype": str(dtype)[6:], "case": case, "tol": tol}
            row.update(_hold_stats(f"flash {case} {dtype}", dtype, mm, inv, ref_m, ref_inv))
            for name, x, y in (("out", out, ref), ("dq", got[0], want[0]), ("dk", got[1], want[1]),
                               ("dv", got[2], want[2])):
                x, y = x.float(), y.float()
                row[name] = float((x - y).abs().max())
                row[name + "_max_abs"] = float(y.abs().max())
                check(bool(torch.isfinite(x).all()), f"flash {case} {dtype} {name}: non-finite")
                check(torch.allclose(x, y, rtol=tol, atol=tol),
                      f"flash {case} {dtype} {name} differs from the plain twin by {row[name]}")
            if case == "holes":   # batch rows 0 and 1: no valid key, inv = 0 in every row
                check(float(out[:2].abs().max()) == 0.0, "fully masked rows are not zero")
                check(max(float(t[:2].abs().max()) for t in got) == 0.0,
                      "rows with inv = 0 have nonzero gradients")
            if dtype == torch.bfloat16 and case in ("train", "unaligned"):
                acc = fa._bwd_scratch(fa.flash_attention_bwd, *a, mm)[1]
                check((acc is None) == (case == "unaligned"),
                      f"flash {case}: dq accumulator {acc is not None}, against the C path rule")
            if dtype == torch.bfloat16 and case == "train":
                errs = {"fwd": row["out"], "bwd": max(row["dq"], row["dk"], row["dv"])}
            checks.append(row)
            log(f"flash vs plain {row}")
    del out, ref, got, want

    # ---- phase 8: 2-user fp32 train step, GPU against CPU ----
    cpu = torch.device("cpu")
    cfg0 = dataclasses.replace(cfg, dropout=0.0, input_dropout=0.0)
    two = _seq_batch(ids[:2], ids_fut[:2], users[:2], dev)
    index_cpu = semids.CorpusIndex(index.cached_ids.to(cpu), index.sorted_keys.to(cpu),
                                   index.bases, index.codebook_size, index.n_distinct)
    p_gpu = tree_map(lambda t: t.detach().clone(), params)
    loss_g, _, grads_g = td.value_and_grad(td._make_microbatch_loss(cfg0, index, torch.float32),
                                           p_gpu, two, None)
    loss_c, _, grads_c = td.value_and_grad(
        td._make_microbatch_loss(cfg0, index_cpu, torch.float32), _to_device(p_gpu, cpu),
        type(two)(*(t.to(cpu) for t in two)), None)
    loss_rel = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    leaf_rel = 0.0
    for a, b in zip(tree_leaves(grads_g), tree_leaves(grads_c)):
        err = float((a.cpu() - b).abs().max())
        scale = float(b.abs().max())
        check(err <= 1e-3 * scale + 1e-12, f"GPU vs CPU gradient leaf differs: {err} of {scale}")
        leaf_rel = max(leaf_rel, err / scale if scale else 0.0)
    check(loss_rel <= 1e-4, f"GPU vs CPU fp32 loss differs by {loss_rel} relative")
    log(f"2-user fp32 step GPU vs CPU: loss {float(loss_c):.6f}, rel err {loss_rel:.2e}, "
        f"worst leaf {leaf_rel:.2e} of its max-abs")
    del p_gpu, grads_g, grads_c

    # ---- phase 9: ML-32M serving through the flash forward kernel ----
    n_tok = ML_HIST * 4
    gen_params = amp.cast_floating(params, torch.bfloat16)
    tok = TokenizedSeqBatch(
        user_ids=torch.arange(ML_GEN_BATCH, device=dev, dtype=torch.int32),
        sem_ids=torch.from_numpy(rng.randint(0, 256, (ML_GEN_BATCH, n_tok)).astype(np.int32)).to(dev),
        sem_ids_fut=None, seq_mask=torch.ones((ML_GEN_BATCH, n_tok), dtype=torch.bool, device=dev),
        token_type_ids=torch.arange(4, device=dev, dtype=torch.int32).repeat(ML_GEN_BATCH, ML_HIST),
        token_type_ids_fut=None)

    def serve():
        return generation.generate_next_sem_ids(gen_params, cfg, index, tok, k=BEAMS,
                                                n_candidates=256)

    fa.flash_attention_fwd.launches = 0
    children_window.launches = 0
    out = serve()
    torch.cuda.synchronize()
    serve_launches = {"flash_attention_fwd": fa.flash_attention_fwd.launches,
                      "children_window": children_window.launches}
    check(serve_launches["flash_attention_fwd"] == 4,
          f"ML-32M serving: {serve_launches} (the encoder's 4 layers take the flash kernel)")
    check(bool(torch.isfinite(out.log_probas).all()), "ML-32M serving: non-finite log-probas")
    live = out.log_probas > generation.INVALID_PENALTY / 2
    check(bool(semids.exists_prefix(index, out.sem_ids)[live].all()),
          "ML-32M serving: an unpenalised beam is not a corpus item")
    ml_gen_ms = wall_ms(serve, 5)
    ml_serving = dict(generate_ms=ml_gen_ms, queries_per_s=ML_GEN_BATCH / (ml_gen_ms / 1e3),
                      batch=ML_GEN_BATCH, encoder_tokens=n_tok + 1, beams=BEAMS,
                      corpus_items=ML_ITEMS, launches=serve_launches,
                      live_beams=int(live.sum()))
    log(f"ML-32M serving: {ml_serving}")
    del gen_params, out

    # ---- phase 10: timings at the full training shape ----
    train_profile = _profile(lambda: step(params, opt_state, flat, gen), top=12)
    del params, opt_state
    torch.cuda.empty_cache()
    b, h, n, dh = q.shape
    bias = fa.mask_bias(km, b, n, dev)
    fwd_out, mm, inv = fa.flash_attention_fwd(q, k, v, k_mask=km)
    kernel_ms = {"fwd": cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, k_mask=km), 5, warmup=1),
                 "bwd": cuda_ms(lambda: fa.flash_attention_bwd(q, k, v, g, mm, inv, k_mask=km), 3,
                                warmup=1)}
    plain_ms = {"fwd": cuda_ms(lambda: fa.flash_attention_plain(q, k, v, k_mask=km), 3, warmup=1),
                "bwd": cuda_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, g, k_mask=km), 3,
                               warmup=1)}
    torch.cuda.empty_cache()
    lib_mask = bias[:, None, None, :].to(q.dtype)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    sdpa_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(*leaves, attn_mask=lib_mask), 10)
    sdpa_fwd_bwd = cuda_ms(lambda: torch.autograd.backward(
        F.scaled_dot_product_attention(*leaves, attn_mask=lib_mask), g), 10)
    del leaves
    # the work counts the valid keys: a masked key adds exactly nothing, and
    # the forward skips tiles of them, so its operations are the (q, k) pairs
    # with a valid key and its K / V reads those keys' rows; q, out, g and
    # the gradients cover every row (the dense count beside)
    valid_keys = int(km.sum())
    pairs = h * n * valid_keys
    dense_pairs = b * h * n * n
    fwd_flops = 4 * dh * pairs
    elt = q.element_size()
    kv_bytes = elt * 2 * h * dh * valid_keys
    fwd_bytes = elt * 2 * b * h * n * dh + kv_bytes + 4 * b * n + 8 * b * h * n
    bwd_bytes = elt * 5 * b * h * n * dh + kv_bytes + 4 * b * n + 8 * b * h * n
    flash_kernels = []
    for name, flops, nbytes, line, lib in (
            ("flash_attention_fwd", fwd_flops, fwd_bytes, 41, sdpa_fwd),
            ("flash_attention_bwd", fwd_flops * 10 // 4, bwd_bytes, 121, sdpa_fwd_bwd - sdpa_fwd)):
        t_ops, t_bytes = flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
        short = name.rsplit("_", 1)[1]
        flash_kernels.append(dict(
            name=name, route="cuda", source=f"rqvae_tpu_torch/csrc/{name}.cu",
            replaces=f"rqvae_tpu/ops/flash_attention.py:{line}",
            launches=launches[name], max_abs_err=errs[short], ms=kernel_ms[short],
            plain_ms=plain_ms[short], bound_ms=max(t_ops, t_bytes) * 1e3,
            bound_by="operations" if t_ops > t_bytes else "bytes", library_ms=lib))
    log(f"flash kernels at B={b}, H={h}, N={n}, Dh={dh} {q.dtype}: {flash_kernels}")

    # dense sdpa (the port's plain path) against flash_attention, BNHD operands
    # from one fused qkv product as the transformer makes them
    cut = {}
    for n_tok_cut in (801, 81):
        qkv = torch.randn((b, n_tok_cut, 3 * h * dh), device=dev, generator=gen).to(torch.bfloat16)
        qkv.requires_grad_(True)
        qb, kb, vb = (attn_ops.split_heads(t, h) for t in torch.chunk(qkv, 3, dim=-1))
        keep = torch.ones((b, n_tok_cut), dtype=torch.bool, device=dev)
        dense_mask = attn_ops.build_mask(n_tok_cut, n_tok_cut, k_mask=keep)
        grad = torch.randn((b, n_tok_cut, h, dh), device=dev, generator=gen).to(torch.bfloat16)

        def dense():
            return attn_ops.sdpa(qb, kb, vb, dense_mask)

        def flash():
            return real_flash(qb.transpose(1, 2), kb.transpose(1, 2), vb.transpose(1, 2),
                              k_mask=keep).transpose(1, 2)

        with torch.no_grad():
            fwd = {"dense": cuda_ms(dense, 5, warmup=1), "flash": cuda_ms(flash, 5, warmup=1)}
        both = {"dense": cuda_ms(lambda: dense().backward(grad), 3, warmup=1),
                "flash": cuda_ms(lambda: flash().backward(grad), 3, warmup=1)}
        cut[str(n_tok_cut)] = dict(fwd_ms=fwd, fwd_bwd_ms=both)
        del qkv, qb, kb, vb, grad
        torch.cuda.empty_cache()
    log(f"dense vs flash at B={b}: {cut}")

    train = dict(flat=flat_out, bucketed=bucketed_out, flash_checks=checks,
                 gpu_vs_cpu=dict(users=2, tokens=ML_HIST * 4 + 1, loss_rel_err=loss_rel,
                                 worst_leaf_rel_err=leaf_rel),
                 flash_bounds=dict(valid_pairs=pairs, dense_pairs=dense_pairs,
                                   valid_share=pairs / dense_pairs,
                                   bytes={"fwd": fwd_bytes, "bwd": bwd_bytes},
                                   fwd_exp_floor_ms=pairs / EXP_PER_S * 1e3,
                                   dense_bound_ms={"fwd": 4 * dh * dense_pairs / BF16_FLOP_PER_S * 1e3,
                                                   "bwd": 10 * dh * dense_pairs / BF16_FLOP_PER_S * 1e3}),
                 sdpa_library_ms=dict(fwd=sdpa_fwd, fwd_bwd=sdpa_fwd_bwd),
                 dense_vs_flash=cut, train_profile=train_profile)
    return train, ml_serving, flash_kernels


def _packed(dev):
    """Phases 16-19: packed long-context decoder training (``bench.py
    --profile ml32m_packed``), the span kernels against their twins, a
    2-row fp32 packed step GPU vs CPU, and the span kernels' times. Returns
    (packed dict, kernel entries)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from rqvae_tpu_torch.data import packing
    from rqvae_tpu_torch.data.dataset import SeqDataset
    from rqvae_tpu_torch.models import retrieval
    from rqvae_tpu_torch.ops import attention as attn_ops
    from rqvae_tpu_torch.ops import flash_attention as fa
    from rqvae_tpu_torch.tokenizer import semids
    from rqvae_tpu_torch.train import optim
    from rqvae_tpu_torch.train import train_decoder as td
    from rqvae_tpu_torch.utils.tree import tree_leaves, tree_map

    cfg = _ml32m_config()
    rng = np.random.RandomState(SEED)
    index = _ml32m_index(rng, dev)     # the ML-32M phases' corpus, drawn the same way
    # full ML_HIST-item histories; the packer's random crop gives the real
    # training length distribution
    seqs = SeqDataset(user_ids=np.arange(PACK_USERS, dtype=np.int32),
                      item_ids=rng.randint(0, ML_ITEMS, (PACK_USERS, ML_HIST)).astype(np.int32),
                      item_ids_fut=rng.randint(0, ML_ITEMS, (PACK_USERS, 1)).astype(np.int32),
                      max_seq_len=ML_HIST)
    packer = packing.SequencePacker(seqs=seqs, rng=np.random.default_rng(0), rows=PACK_ROWS,
                                    slots=PACK_SLOTS)
    for _ in range(3):   # past the buffer's warm-up, which skims long crops
        packer.next_batch()
    cycle = [packer.next_batch() for _ in range(8)]
    batches = [packing.to_device(b, dev) for b, _ in cycle]
    n_ex = [n for _, n in cycle]
    placed = np.concatenate([b.slot_len[b.slot_valid] for b, _ in cycle])
    enc_tokens = PACK_SLOTS + ML_HIST * 4
    real_tokens = sum(int(b.slot_valid.sum()) + 4 * int((b.ids >= 0).sum()) for b, _ in cycle)
    token_share = real_tokens / (len(cycle) * PACK_ROWS * enc_tokens)
    log(f"packed cycle: {PACK_ROWS} rows x {PACK_SLOTS} slots x {ML_HIST} items "
        f"({enc_tokens} encoder tokens), examples per batch {n_ex}, mean placed crop "
        f"{float(placed.mean()):.1f} items, non-padding encoder tokens {token_share:.3f}")

    params = retrieval.init(torch.Generator().manual_seed(SEED), cfg, device=dev)
    opt = optim.adamw(3e-4, 0.035)
    opt_state = opt.init(params)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    step = td.make_packed_step(cfg, opt, index, torch.bfloat16)

    # ---- phase 16: the packed step, counted ----
    losses = []
    for i in range(3):
        params, opt_state, m = step(params, opt_state, batches[i % 8], gen)
        losses.append(float(m["total_loss"]))
    torch.cuda.synchronize()
    counters = (fa.flash_attention_spans_fwd, fa.flash_attention_spans_bwd,
                fa.flash_attention_fwd, fa.flash_attention_bwd)
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    n_steps = 10
    timed, step_losses = 0, []
    t0 = time.perf_counter()
    for i in range(n_steps):
        params, opt_state, m = step(params, opt_state, batches[i % 8], gen)
        step_losses.append(m["total_loss"])
        timed += n_ex[i % 8]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / n_steps
    launches = {c.__name__: c.launches for c in counters}
    losses += [float(x) for x in step_losses]
    log(f"packed step: {step_s * 1e3:.1f} ms, losses {losses}, launches {launches}")
    check(all(math.isfinite(x) for x in losses), f"non-finite packed loss {losses}")
    for name in ("flash_attention_spans_fwd", "flash_attention_spans_bwd"):
        check(launches[name] == 4 * n_steps,
              f"{name}: {launches[name]} launches in {n_steps} steps, expected 4 per step")
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        check(launches[name] == 0, f"{name}: {launches[name]} launches in the packed step")
    packed = dict(train_step_ms=step_s * 1e3, train_examples_per_s=timed / (step_s * n_steps),
                  steps_timed=n_steps, losses=losses, rows=PACK_ROWS, slots=PACK_SLOTS,
                  capacity_items=ML_HIST, encoder_tokens=enc_tokens,
                  mean_examples_per_step=float(np.mean(n_ex)),
                  mean_placed_crop_items=float(placed.mean()),
                  non_padding_encoder_token_share=token_share,
                  spans_fwd_per_step=launches["flash_attention_spans_fwd"] / n_steps,
                  spans_bwd_per_step=launches["flash_attention_spans_bwd"] / n_steps,
                  flash_launches=launches["flash_attention_fwd"] + launches["flash_attention_bwd"],
                  peak_memory_gb=torch.cuda.max_memory_allocated() / 2**30)

    # ---- phase 17: the span kernels against their twins ----
    # encoder layer 0's operands, recorded from a rerun of the step
    rec = {}
    real_spans = attn_ops.flash_attention_spans

    def record(q, k, v, lo, hi, extra):
        out = real_spans(q, k, v, lo, hi, extra)
        if not rec:  # the first call of a step: encoder layer 0
            rec.update(q=q.detach(), k=k.detach(), v=v.detach(), spans=(lo, hi, extra))
            out.register_hook(lambda g: rec.__setitem__("g", g.detach()))
        return out

    attn_ops.flash_attention_spans = record
    try:
        params, opt_state, _ = step(params, opt_state, batches[0], gen)
    finally:
        attn_ops.flash_attention_spans = real_spans
    torch.cuda.synchronize()
    check(set(rec) == {"q", "k", "v", "spans", "g"}, f"recorded {sorted(rec)}")
    q, k, v, g = rec["q"], rec["k"], rec["v"], rec["g"]
    lo, hi, extra = rec["spans"]
    b, h, n, dh = q.shape
    check((b, h, n, dh) == (PACK_ROWS, 8, enc_tokens, 64) and q.dtype == torch.bfloat16,
          f"recorded layer-0 operands {tuple(q.shape)} {q.dtype}")
    small = min(16, b)
    qs, ks, vs = q[:small], k[:small], v[:small]
    gs = g[:small].float()
    gs = (gs / gs.pow(2).mean().sqrt()).to(g.dtype)
    sgen = np.random.RandomState(SEED + 4)

    def bounds(lo_np, hi_np, ex_np):
        return tuple(torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)
                     for a in (lo_np, hi_np, ex_np))

    rec_np = [t[:small].cpu().numpy() for t in (lo, hi, extra)]
    empty = [a.copy() for a in rec_np]
    empty_rows = np.zeros((small, n), bool)
    empty_rows[:, ::7] = True          # every 7th query and two whole rows attend nothing
    empty_rows[:2] = True
    empty[0][empty_rows], empty[1][empty_rows], empty[2][empty_rows] = 0, 0, -1
    extra_only = (np.zeros((small, n)), np.zeros((small, n)), sgen.randint(0, n, (small, n)))
    t_lo = 64 * sgen.randint(1, n // 64, (small, n)) - sgen.randint(1, 40, (small, n))
    edges = (t_lo, t_lo + sgen.randint(2, 140, (small, n)), np.full((small, n), -1))
    w_lo = sgen.randint(0, n - 200, (small, n))
    w_hi = w_lo + sgen.randint(1, 200, (small, n))
    outside = np.where(sgen.rand(small, n) < 0.5, sgen.randint(0, n, (small, n)), w_hi)
    cases = (("train", bounds(*rec_np), n), ("empty", bounds(*empty), n),
             ("extra_only", bounds(*extra_only), n), ("tile_edges", bounds(*edges), n),
             ("extra_outside", bounds(w_lo, w_hi, outside), n),
             ("nq_777", bounds(*(a[:, :777] for a in rec_np)), 777))
    checks, errs = [], {"fwd": 0.0, "bwd": 0.0}
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        for case, spans, nq in cases:
            a = [t.to(dtype) for t in (qs[:, :, :nq], ks, vs, gs[:, :, :nq])]
            out, mm, inv = fa.flash_attention_spans_fwd(*a[:3], *spans)
            ref, ref_m, ref_inv = fa._plain_fwd(*a[:3], fa._span_masker(*spans))
            got = fa.flash_attention_spans_bwd(*a[:3], *spans, a[3], mm, inv)
            want = fa.flash_attention_spans_bwd_plain(*a[:3], *spans, a[3])
            torch.cuda.synchronize()
            row = {"dtype": str(dtype)[6:], "case": case, "nq": nq, "tol": tol}
            row.update(_hold_stats(f"spans {case} {dtype}", dtype, mm, inv, ref_m, ref_inv))
            for name, x, y in (("out", out, ref), ("dq", got[0], want[0]), ("dk", got[1], want[1]),
                               ("dv", got[2], want[2])):
                x, y = x.float(), y.float()
                row[name] = float((x - y).abs().max())
                row[name + "_max_abs"] = float(y.abs().max())
                check(bool(torch.isfinite(x).all()), f"spans {case} {dtype} {name}: non-finite")
                check(torch.allclose(x, y, rtol=tol, atol=tol),
                      f"spans {case} {dtype} {name} differs from the plain twin by {row[name]}")
            if case == "empty":
                masked = torch.from_numpy(empty_rows).to(dev)[:, None, :, None].expand_as(out)
                check(float(out[masked].abs().max()) == 0.0, "fully masked rows are not zero")
                check(float(got[0][masked].abs().max()) == 0.0, "rows with inv = 0 have nonzero dq")
            if dtype == torch.bfloat16 and case == "train":
                check(fa._bwd_scratch(fa.flash_attention_spans_bwd, *a, mm)[1] is not None,
                      "spans train: the C path rule gives no dq accumulator")
            if dtype == torch.bfloat16 and case == "train":
                errs = {"fwd": row["out"], "bwd": max(row["dq"], row["dk"], row["dv"])}
            checks.append(row)
            log(f"spans vs plain {row}")
    del out, ref, got, want

    # ---- phase 18: a 2-row fp32 packed step, GPU against CPU ----
    cpu = torch.device("cpu")
    cfg0 = dataclasses.replace(cfg, dropout=0.0, input_dropout=0.0)
    two = packing.PackedSeqBatch(*(t[:2] for t in batches[0]))
    index_cpu = semids.CorpusIndex(index.cached_ids.to(cpu), index.sorted_keys.to(cpu),
                                   index.bases, index.codebook_size, index.n_distinct)

    class Capture:
        """An optimizer that keeps the gradients and leaves the params."""

        def update(self, params, state, grads):
            self.grads = tree_leaves(grads)
            return state

    runs = []
    for device, idx in ((dev, index), (cpu, index_cpu)):
        cap = Capture()
        p = tree_map(lambda t: t.detach().to(device, copy=True), params)
        _, _, m = td.make_packed_step(cfg0, cap, idx, torch.float32)(
            p, None, packing.PackedSeqBatch(*(t.to(device) for t in two)), None)
        runs.append((float(m["total_loss"]), cap.grads))
    (loss_g, grads_g), (loss_c, grads_c) = runs
    loss_rel = abs(loss_g - loss_c) / abs(loss_c)
    leaf_rel = 0.0
    for a, b_ in zip(grads_g, grads_c):
        err = float((a.cpu() - b_).abs().max())
        scale = float(b_.abs().max())
        check(err <= 1e-3 * scale + 1e-12, f"packed GPU vs CPU gradient leaf differs: {err} of {scale}")
        leaf_rel = max(leaf_rel, err / scale if scale else 0.0)
    check(loss_rel <= 1e-4, f"packed GPU vs CPU fp32 loss differs by {loss_rel} relative")
    log(f"2-row fp32 packed step GPU vs CPU: loss {loss_c:.6f}, rel err {loss_rel:.2e}, "
        f"worst leaf {leaf_rel:.2e} of its max-abs")
    del runs, grads_g, grads_c

    # ---- phase 19: the span kernels' times on phase 16's operands ----
    packed["train_profile"] = _profile(lambda: step(params, opt_state, batches[0], gen), top=12)
    del params, opt_state
    torch.cuda.empty_cache()
    allow = attn_ops.span_mask((lo, hi, extra), n)        # (B, Nq, Nk) bool
    pairs = h * int(allow.sum())                           # allowed (q, k) pairs, all heads
    dense_pairs = b * h * n * n
    fwd_out, mm, inv = fa.flash_attention_spans_fwd(q, k, v, lo, hi, extra)
    kernel_ms = {"fwd": cuda_ms(lambda: fa.flash_attention_spans_fwd(q, k, v, lo, hi, extra), 10,
                                warmup=2),
                 "bwd": cuda_ms(lambda: fa.flash_attention_spans_bwd(q, k, v, lo, hi, extra, g, mm,
                                                                     inv), 5, warmup=1)}
    plain_ms = {"fwd": cuda_ms(lambda: fa.flash_attention_spans_plain(q, k, v, lo, hi, extra), 3,
                               warmup=1),
                "bwd": cuda_ms(lambda: fa.flash_attention_spans_bwd_plain(q, k, v, lo, hi, extra, g),
                               3, warmup=1)}
    torch.cuda.empty_cache()
    lib_bias = torch.where(allow, 0.0, attn_ops.NEG_INF)[:, None].to(q.dtype)   # (B, 1, Nq, Nk)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    sdpa_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(*leaves, attn_mask=lib_bias), 10)
    sdpa_fwd_bwd = cuda_ms(lambda: torch.autograd.backward(
        F.scaled_dot_product_attention(*leaves, attn_mask=lib_bias), g), 10)
    del leaves, lib_bias
    # K / V are read for the keys some row attends (the forward skips the
    # tiles no row of a block attends); q, out, g and the gradients cover
    # every row
    attended = int(allow.any(dim=1).sum())
    elt = q.element_size()
    kv_bytes = elt * 2 * h * dh * attended
    fwd_bytes = elt * 2 * b * h * n * dh + kv_bytes + 12 * b * n + 8 * b * h * n
    bwd_bytes = elt * 5 * b * h * n * dh + kv_bytes + 12 * b * n + 8 * b * h * n
    kernels = []
    for name, per_pair, nbytes, line, lib in (
            ("flash_attention_spans_fwd", 4, fwd_bytes, 491, sdpa_fwd),
            ("flash_attention_spans_bwd", 10, bwd_bytes, 513, sdpa_fwd_bwd - sdpa_fwd)):
        t_ops, t_bytes = per_pair * dh * pairs / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
        short = name.rsplit("_", 1)[1]
        kernels.append(dict(
            name=name, route="cuda", source=f"rqvae_tpu_torch/csrc/{name}.cu",
            replaces=f"rqvae_tpu/ops/flash_attention.py:{line}",
            launches=launches[name], max_abs_err=errs[short], ms=kernel_ms[short],
            plain_ms=plain_ms[short], bound_ms=max(t_ops, t_bytes) * 1e3,
            bound_by="operations" if t_ops > t_bytes else "bytes", library_ms=lib))
    packed.update(
        span_checks=checks,
        gpu_vs_cpu=dict(rows=2, tokens=enc_tokens, loss_rel_err=loss_rel,
                        worst_leaf_rel_err=leaf_rel),
        span_bounds=dict(allowed_pairs=pairs, dense_pairs=dense_pairs,
                         allowed_share=pairs / dense_pairs,
                         attended_key_share=attended / (b * n),
                         bytes={"fwd": fwd_bytes, "bwd": bwd_bytes},
                         fwd_exp_floor_ms=pairs / EXP_PER_S * 1e3,
                         dense_bound_ms={"fwd": 4 * dh * dense_pairs / BF16_FLOP_PER_S * 1e3,
                                         "bwd": 10 * dh * dense_pairs / BF16_FLOP_PER_S * 1e3}),
        sdpa_library_ms=dict(fwd=sdpa_fwd, fwd_bwd=sdpa_fwd_bwd))
    log(f"span kernels at B={b}, H={h}, N={n}, Dh={dh} {q.dtype}, allowed share "
        f"{pairs / dense_pairs:.3f}: {kernels}")
    return packed, kernels


def _stage1(dev, work):
    """Phases 11-15: stage-1 RQ-VAE training at the flagship (Amazon) and the
    stretch shape, rq_quantize_train and the K-tiled rq_tokenize against their
    twins, GPU vs CPU, and the route timings. The flagship checkpoints under
    ``work``. Returns (train_rqvae dict, kernel entries, the flagship's
    checkpoint directory)."""
    import numpy as np
    import torch

    from rqvae_tpu_torch.data.synthetic import synthetic_items
    from rqvae_tpu_torch.models import quantize, rqvae
    from rqvae_tpu_torch.ops import quantize_kernels as qk
    from rqvae_tpu_torch.train import checkpoint, optim
    from rqvae_tpu_torch.train import train_rqvae as tr
    from rqvae_tpu_torch.utils import config as config_lib
    from rqvae_tpu_torch.utils.logging import MetricsLogger
    from rqvae_tpu_torch.utils.tree import tree_leaves, tree_map

    n_chunks = math.ceil(N_ITEMS / 4096)  # precompute_corpus_ids' chunks

    # ---- phase 11: the flagship through train() ----
    class Capture(MetricsLogger):
        def __init__(self):
            super().__init__(every=1)
            self.records = []

        def log(self, step, metrics, force=False):
            self.records.append({"step": step, "t": time.perf_counter(),
                                 **{k: float(np.asarray(v)) for k, v in metrics.items()}})

    real_prime = rqvae.kmeans_prime
    prime_ms = []

    def timed_prime(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        primed = real_prime(*args, **kwargs)
        torch.cuda.synchronize()
        prime_ms.append((time.perf_counter() - t0) * 1e3)
        return primed

    config = pathlib.Path(__file__).resolve().parent / "configs" / "rqvae_amazon.json"
    cap = Capture()
    rqvae.kmeans_prime = timed_prime
    rq_ckpt = f"{work}/rqvae"
    try:
        cfg = config_lib.load_config(tr.RqVaeTrainConfig, str(config), [
            "dataset=SYNTHETIC", f"synthetic_n_items={N_ITEMS}", f"seed={SEED}",
            f"iterations={RQ_ITERS}", "steps_per_call=8", "log_every=100",
            f"eval_every={RQ_ITERS}", f"save_model_every={RQ_ITERS}",
            f"save_dir_root={rq_ckpt}"])
        qk.rq_tokenize.launches = 0
        qk.rq_quantize_train.launches = 0
        t0 = time.perf_counter()
        flag_params = tr.train(cfg, logger=cap, device=dev)
        torch.cuda.synchronize()
        flag_s = time.perf_counter() - t0
        flag_launches = {"rq_tokenize": qk.rq_tokenize.launches,
                         "rq_quantize_train": qk.rq_quantize_train.launches}
        saved = checkpoint.latest_step(rq_ckpt)
    finally:
        rqvae.kmeans_prime = real_prime
    acfg = cfg.model_config()
    logs = [r for r in cap.records if "total_loss" in r]
    evals = [r for r in cap.records if "eval_total_loss" in r]
    losses = [r["total_loss"] for r in logs]
    log(f"stage-1 flagship: {flag_s:.1f} s, losses {losses}, launches {flag_launches}, "
        f"eval {evals}")
    check([r["step"] for r in logs] == [1] + list(range(100, RQ_ITERS + 1, 100)),
          f"flagship log steps {[r['step'] for r in logs]}")
    check(all(math.isfinite(x) for x in losses), f"non-finite flagship loss {losses}")
    check(losses[-1] < losses[0], f"flagship loss did not fall: {losses}")
    check(len(evals) == 1 and evals[0]["step"] == RQ_ITERS, f"flagship evals {evals}")
    check(all(math.isfinite(v) for v in evals[0].values()), f"non-finite eval {evals}")
    check(flag_launches == {"rq_tokenize": n_chunks, "rq_quantize_train": 0},
          f"flagship launches {flag_launches}: the eval tokenizes through rq_tokenize, the "
          f"plain route (volume {acfg.codebook_size * acfg.embed_dim}) skips rq_quantize_train")
    check(saved == RQ_ITERS - 1, f"flagship checkpoint step {saved}")
    step_ms = (logs[-1]["t"] - logs[0]["t"]) * 1e3 / (logs[-1]["step"] - logs[0]["step"])
    flagship = dict(kmeans_prime_ms=prime_ms[0], train_step_ms=step_ms,
                    train_examples_per_s=cfg.batch_size / (step_ms / 1e3), losses=losses,
                    eval={k: v for k, v in evals[0].items() if k != "t"}, launches=flag_launches,
                    wall_s=flag_s, checkpoint_step=saved, batch=cfg.batch_size,
                    iterations=RQ_ITERS, steps_per_call=cfg.steps_per_call)

    # ---- phase 12: the stretch shape, device-resident chunks on the fused route ----
    mcfg = rqvae.RqVaeConfig(input_dim=INPUT_DIM, embed_dim=STRETCH_EMBED,
                             hidden_dims=(512, 256, 128), codebook_size=STRETCH_K,
                             n_layers=STRETCH_LEVELS, n_cat_feats=0,
                             codebook_mode="ROTATION_TRICK")
    check(mcfg.codebook_size * mcfg.embed_dim >= rqvae.FUSED_TRAIN_MIN_CODEBOOK_VOLUME,
          "the stretch shape should take the fused route")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    corpus = torch.randn((N_ITEMS, INPUT_DIM), generator=gen, device=dev)
    params = rqvae.init(torch.Generator().manual_seed(SEED), mcfg, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = rqvae.kmeans_prime(params, mcfg, corpus, gen)
    torch.cuda.synchronize()
    stretch_prime_ms = (time.perf_counter() - t0) * 1e3
    opt = optim.adamw(5e-4, 0.01)
    opt_state = opt.init(params)
    chunk = tr.make_device_chunk(mcfg, opt, 1, torch.bfloat16, STRETCH_BATCH, STRETCH_STEPS)
    params, opt_state, m = chunk(params, opt_state, corpus, gen, 0.2)  # warm-up
    first_loss = float(m["total_loss"])
    qk.rq_quantize_train.launches = 0
    t0 = time.perf_counter()
    for _ in range(STRETCH_CHUNKS):
        params, opt_state, m = chunk(params, opt_state, corpus, gen, 0.2)
    torch.cuda.synchronize()
    stretch_ms = (time.perf_counter() - t0) * 1e3 / (STRETCH_CHUNKS * STRETCH_STEPS)
    stretch_launches = qk.rq_quantize_train.launches
    last_loss = float(m["total_loss"])
    check(stretch_launches == STRETCH_CHUNKS * STRETCH_STEPS,
          f"rq_quantize_train: {stretch_launches} launches in {STRETCH_CHUNKS * STRETCH_STEPS} "
          "stretch steps, expected one per step")
    check(math.isfinite(first_loss) and math.isfinite(last_loss),
          f"non-finite stretch loss {first_loss}, {last_loss}")
    # the corpus chunks that the diversity metrics tokenize, with the ids
    # they got, are recorded to be held against the twin in phase 13
    div_calls = []
    real_tok = rqvae.rq_tokenize

    def record_tok(z, cbs, commitment_weight):
        out = real_tok(z, cbs, commitment_weight=commitment_weight)
        div_calls.append((z.detach().clone(), cbs.detach().clone(), commitment_weight, out))
        return out

    qk.rq_tokenize.launches = 0
    rqvae.rq_tokenize = record_tok
    try:
        div = tr.id_diversity_metrics(params, mcfg, corpus)
        torch.cuda.synchronize()
    finally:
        rqvae.rq_tokenize = real_tok
    div_launches = qk.rq_tokenize.launches
    check(div_launches == n_chunks, f"stretch diversity metrics: {div_launches} rq_tokenize launches")
    log(f"stage-1 stretch: {stretch_ms:.2f} ms/step, loss {first_loss:.4f} -> {last_loss:.4f}, "
        f"k-means priming {stretch_prime_ms:.0f} ms, diversity {div}")
    stretch_profile = _profile(lambda: chunk(params, opt_state, corpus, gen, 0.2), top=10)
    stretch = dict(train_step_ms=stretch_ms, train_examples_per_s=STRETCH_BATCH / (stretch_ms / 1e3),
                   kmeans_prime_ms=stretch_prime_ms, losses=[first_loss, last_loss],
                   rq_quantize_train_launches=stretch_launches,
                   steps_timed=STRETCH_CHUNKS * STRETCH_STEPS, batch=STRETCH_BATCH,
                   steps_per_call=STRETCH_STEPS,
                   diversity={k: float(v) for k, v in div.items()},
                   rq_tokenize_launches=div_launches, chunk_profile=stretch_profile)

    # ---- phase 13: the kernels against their twins on the stretch step's operands ----
    rec = {}
    real_fused = rqvae.rq_quantize_train

    def record(x, cbs, mode, beta):
        rec.setdefault("x", x.detach().clone())
        rec.setdefault("cbs", cbs.detach().clone())
        return real_fused(x, cbs, mode, beta)

    rqvae.rq_quantize_train = record
    try:
        one = tr.make_device_chunk(mcfg, opt, 1, torch.bfloat16, STRETCH_BATCH, 1)
        params, opt_state, _ = one(params, opt_state, corpus, gen, 0.2)
    finally:
        rqvae.rq_quantize_train = real_fused
    torch.cuda.synchronize()
    check(rec["x"].dtype == torch.bfloat16
          and tuple(rec["x"].shape) == (STRETCH_BATCH, STRETCH_EMBED),
          f"recorded encoder output {rec['x'].dtype} {tuple(rec['x'].shape)}")
    xs = rec["x"].float().contiguous()
    cbs = rec["cbs"].float().contiguous()
    with torch.no_grad():
        k_out = qk.rq_quantize_train(xs, cbs, "ROTATION_TRICK", 0.25)
        p_out = qk.rq_quantize_train_plain(xs, cbs, commitment_weight=0.25)
    near = _near_ties(xs, cbs, p_out.sem_ids)
    differ = (k_out.sem_ids != p_out.sem_ids).any(-1)
    check(not bool((differ & ~near).any()), "rq_quantize_train ids differ off near-ties")
    same = ~differ
    train_err = 0.0
    for name in ("embeddings", "residuals", "quantize_loss"):
        a, b = getattr(k_out, name)[same], getattr(p_out, name)[same]
        check(torch.allclose(a, b, rtol=1e-5, atol=1e-5),
              f"rq_quantize_train {name} differs from the plain twin")
        train_err = max(train_err, float((a - b).abs().max()))
    log(f"rq_quantize_train vs plain: {int(differ.sum())} rows with other ids, "
        f"{int(near.sum())} near-tie rows, max |err| {train_err:.2e}")

    # gradients: the Function on the card against the plain per-level chain,
    # on the rows without a near-tie (there the two may pick other codes)
    keep = ~near
    w = torch.randn((STRETCH_EMBED, 16), generator=gen, device=dev) / 8.0

    def readout(embs, q_loss):
        z = torch.sum(embs, dim=-1) @ w
        return torch.mean(torch.sum(z * z, dim=-1)) + torch.mean(q_loss)

    grad_checks = {}
    for mode in ("STE", "ROTATION_TRICK"):
        xa, ca = xs[keep].clone().requires_grad_(True), cbs.clone().requires_grad_(True)
        o = qk.rq_quantize_train(xa, ca, mode, 0.25)
        got = torch.autograd.grad(readout(o.embeddings, o.quantize_loss), (xa, ca))
        xb, cb_ = xs[keep].clone().requires_grad_(True), cbs.clone().requires_grad_(True)
        res, embs, q_loss = xb, [], 0.0
        for level in range(cbs.shape[0]):
            q = quantize.apply({"codebook": cb_[level]}, res,
                               mode=quantize.QuantizeForwardMode[mode], commitment_weight=0.25,
                               training=True)
            q_loss = q_loss + q.loss
            res = res - q.embeddings
            embs.append(q.embeddings)
        want = torch.autograd.grad(readout(torch.stack(embs, dim=-1), q_loss), (xb, cb_))
        row = {}
        for name, a, b in (("x", got[0], want[0]), ("codebooks", got[1], want[1])):
            err, scale = float((a - b).abs().max()), float(b.abs().max())
            check(err <= 1e-4 * scale, f"rq_quantize_train {mode} d{name}: {err} of {scale}")
            row[name] = err / scale
        grad_checks[mode] = row
    log(f"rq_quantize_train gradients vs the plain chain ({int(keep.sum())} rows), "
        f"error / max-abs: {grad_checks}")

    # the K-tiled rq_tokenize at 4 x 2048 x 64: the ids that the diversity
    # metrics got on each corpus chunk (4,096 rows twice, then the 3,909-row
    # tail: 512 blocks of 8 rows, the last one part-filled), and the step's
    # own 1,024 rows
    with torch.no_grad():
        tok_cases = [(f"diversity chunk {i}", z, c, beta, out)
                     for i, (z, c, beta, out) in enumerate(div_calls)]
        tok_cases.append(("stretch batch", xs, cbs, 0.25, qk.rq_tokenize(xs, cbs)))
        tok_checks = {}
        for name, z, c, beta, out in tok_cases:
            n_diff, n_near, n_near_d0, err = _hold_rq_tokenize(z, c, beta, out)
            tok_checks[name] = dict(rows=z.shape[0], id_rows_differ=n_diff, near_tie_rows=n_near,
                                    near_tie_rows_d0=n_near_d0, max_abs_err=err)
    chunk_rows = [z.shape[0] for _, z, *_ in tok_cases[:-1]]
    check(chunk_rows == [min(4096, N_ITEMS - i) for i in range(0, N_ITEMS, 4096)],
          f"diversity chunks {chunk_rows}")
    log(f"K-tiled rq_tokenize vs plain at 4x2048x64: {tok_checks}")

    # odd shapes the main paths do not give: a part-filled last code tile
    # (K = 7, 300, 1000 against 512-code tiles), D padded to a multiple of 4
    # (D = 3), D = 128, and row counts that leave the last block part-filled
    odd_checks = {}
    with torch.no_grad():
        for b_odd, n_lv, k_odd, d_odd in ((37, 2, 32, 16), (100, 3, 300, 128), (513, 2, 1000, 64),
                                          (5, 1, 7, 3)):
            x_odd = torch.randn((b_odd, d_odd), generator=gen, device=dev)
            cb_odd = torch.randn((n_lv, k_odd, d_odd), generator=gen, device=dev) * 0.7
            shape = f"{b_odd}x{n_lv}x{k_odd}x{d_odd}"
            n_diff, n_near, _, err = _hold_rq_tokenize(x_odd, cb_odd, 0.25,
                                                       qk.rq_tokenize(x_odd, cb_odd))
            odd_checks[f"rq_tokenize {shape}"] = dict(id_rows_differ=n_diff, max_abs_err=err)
            k_odd_out = qk.rq_quantize_train(x_odd, cb_odd, "ROTATION_TRICK", 0.25)
            p_odd_out = qk.rq_quantize_train_plain(x_odd, cb_odd, commitment_weight=0.25)
            differ_o = (k_odd_out.sem_ids != p_odd_out.sem_ids).any(-1)
            near_o = _near_ties(x_odd, cb_odd, p_odd_out.sem_ids)
            check(not bool((differ_o & ~near_o).any()),
                  f"rq_quantize_train ids differ off near-ties at {shape}")
            err_o = 0.0
            for name in ("embeddings", "residuals", "quantize_loss"):
                a, b = getattr(k_odd_out, name)[~differ_o], getattr(p_odd_out, name)[~differ_o]
                check(torch.allclose(a, b, rtol=1e-5, atol=1e-5),
                      f"rq_quantize_train {name} differs from the plain twin at {shape}")
                err_o = max(err_o, float((a - b).abs().max()))
            odd_checks[f"rq_quantize_train {shape}"] = dict(id_rows_differ=int(differ_o.sum()),
                                                            max_abs_err=err_o)
    log(f"quantizer kernels vs plain at odd shapes: {odd_checks}")
    kernel_checks = dict(
        rq_quantize_train=dict(id_rows_differ=int(differ.sum()), near_tie_rows=int(near.sum()),
                               max_abs_err=train_err, grad_err_over_max_abs=grad_checks),
        rq_tokenize_4x2048x64=tok_checks, odd_shapes=odd_checks)

    # ---- phase 14: two fp32 steps at the Amazon widths, GPU against CPU ----
    cpu = torch.device("cpu")
    pool = torch.from_numpy(synthetic_items(N_ITEMS, INPUT_DIM, seed=SEED + 1).x[:256]).to(dev)

    def clean_rows(p, x, n=64):
        """n rows of x with no near-tie (1e-4) along their id chain under p."""
        with torch.no_grad():
            z = rqvae.encode(p, acfg, x).float()
            cb = rqvae.effective_codebooks(p, acfg).float()
            ids = qk.rq_quantize_train_plain(z, cb).sem_ids
            rows = x[~_near_ties(z, cb, ids, rel=1e-4)][:n]
        check(rows.shape[0] == n, f"only {rows.shape[0]} rows without a near-tie")
        return rows

    class Recording:
        """AdamW that keeps a copy of every gradient it applies."""

        def __init__(self, opt):
            self.opt, self.grads = opt, []

        def update(self, params, state, grads):
            self.grads.append(tree_leaves(tree_map(lambda g: g.detach().to(cpu, copy=True), grads)))
            return self.opt.update(params, state, grads)

    gpu_cpu = {}
    default_volume = rqvae.FUSED_TRAIN_MIN_CODEBOOK_VOLUME
    for route, volume in (("plain", default_volume), ("fused", 0)):
        rqvae.FUSED_TRAIN_MIN_CODEBOOK_VOLUME = volume
        try:
            runs, batches = [], []
            for device in (dev, cpu):
                p = tree_map(lambda t: t.detach().to(device, copy=True), flag_params)
                opt_r = Recording(optim.adamw(5e-4, 0.01))
                state = opt_r.opt.init(p)
                step = tr.make_train_step(acfg, opt_r, 1, torch.float32)
                step_losses = []
                for i in range(2):
                    if device == dev:
                        batches.append(clean_rows(p, pool[128 * i:128 * (i + 1)]))
                    p, state, m = step(p, state, batches[i].to(device)[None], None, 0.2)
                    step_losses.append(float(m["total_loss"]))
                runs.append((step_losses, opt_r.grads))
        finally:
            rqvae.FUSED_TRAIN_MIN_CODEBOOK_VOLUME = default_volume
        (lg, gg), (lc, gc) = runs
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
        leaf_rel = 0.0
        for step_g, step_c in zip(gg, gc):
            for a, b in zip(step_g, step_c):
                err, scale = float((a - b).abs().max()), float(b.abs().max())
                check(err <= 1e-4 * scale + 1e-12, f"{route}: GPU vs CPU leaf {err} of {scale}")
                leaf_rel = max(leaf_rel, err / scale if scale else 0.0)
        check(loss_rel <= 1e-5, f"{route}: GPU vs CPU stage-1 loss differs by {loss_rel} relative")
        gpu_cpu[route] = dict(losses_gpu=lg, losses_cpu=lc, loss_rel_err=loss_rel,
                              worst_leaf_rel_err=leaf_rel)
    log(f"stage-1 fp32 steps, GPU vs CPU: {gpu_cpu}")

    # ---- phase 15: kernel times and the two routes at both shapes ----
    b, d = xs.shape
    n_lv, n_code = cbs.shape[:2]
    t_bytes = 4 * (b * d + n_lv * n_code * d + 2 * n_lv * b * d + b * n_lv + b)
    t_flops = 2 * b * n_lv * n_code * d
    t_ops, t_mem = t_flops / FP32_FLOP_PER_S, t_bytes / HBM_BYTES_PER_S
    with torch.no_grad():
        train_ms = cuda_ms(lambda: qk.rq_quantize_train(xs, cbs, "ROTATION_TRICK", 0.25), 50)
        train_plain_ms = cuda_ms(lambda: qk.rq_quantize_train_plain(xs, cbs), 50)
        z_big = rqvae.encode(params, mcfg, corpus[:4096]).float().contiguous()
        tok_big_ms = cuda_ms(lambda: qk.rq_tokenize(z_big, cbs), 50)
        tok_big_plain_ms = cuda_ms(lambda: qk.rq_tokenize_plain(z_big, cbs), 20)
    tok_bytes = 4 * (4096 * d + n_lv * n_code * d + 2 * 4096 * d + 4096 * n_lv + 4096)
    tok_flops = 2 * 4096 * n_lv * n_code * d
    stage1_kernels = [dict(
        name="rq_quantize_train", route="cuda", source="rqvae_tpu_torch/csrc/rq_quantize_train.cu",
        replaces="rqvae_tpu/ops/quantize_pallas.py:179", launches=stretch_launches,
        max_abs_err=train_err, ms=train_ms, plain_ms=train_plain_ms,
        bound_ms=max(t_ops, t_mem) * 1e3, bound_by="operations" if t_ops > t_mem else "bytes",
        library_ms=None)]
    log(f"rq_quantize_train at B={b}, {n_lv}x{n_code}x{d}: {stage1_kernels[0]}")

    def route_ms(model_cfg, p0, data, batch, dtype, steps, reps, fused):
        rqvae.FUSED_TRAIN_MIN_CODEBOOK_VOLUME = 0 if fused else float("inf")
        try:
            p = tree_map(lambda t: t.detach().clone(), p0)
            o = optim.adamw(5e-4, 0.01)
            st = o.init(p)
            ch = tr.make_device_chunk(model_cfg, o, 1, dtype, batch, steps)
            p, st, _ = ch(p, st, data, gen, 0.2)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                p, st, _ = ch(p, st, data, gen, 0.2)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / (reps * steps)
        finally:
            rqvae.FUSED_TRAIN_MIN_CODEBOOK_VOLUME = default_volume

    amazon_data = torch.from_numpy(synthetic_items(N_ITEMS, INPUT_DIM, seed=SEED).x).to(dev)
    routes = {}
    for shape, args in (
            ("amazon_3x256x32_bs64_fp32", (acfg, flag_params, amazon_data, 64, torch.float32, 8, 10)),
            ("stretch_4x2048x64_bs1024_bf16", (mcfg, params, corpus, STRETCH_BATCH, torch.bfloat16,
                                               STRETCH_STEPS, 3))):
        runs = {"plain": [], "fused": []}
        for route in ("plain", "fused", "fused", "plain"):
            runs[route].append(route_ms(*args, fused=route == "fused"))
        routes[shape] = {k: v for k, v in runs.items()}
    log(f"stage-1 ms per step by route (plain, fused in turns): {routes}")

    train_rqvae = dict(
        flagship=flagship, stretch=stretch, kernel_checks=kernel_checks, gpu_vs_cpu=gpu_cpu,
        route_ms_per_step=routes, fused_train_min_codebook_volume=default_volume,
        rq_tokenize_4x2048x64=dict(rows=4096, ms=tok_big_ms, plain_ms=tok_big_plain_ms,
                                   bound_ms=max(tok_flops / FP32_FLOP_PER_S,
                                                tok_bytes / HBM_BYTES_PER_S) * 1e3))
    return train_rqvae, stage1_kernels, rq_ckpt


def _amazon_decoder(dev, rq_ckpt, work):
    """Phases 20-23: the Amazon decoder through ``train_decoder.train`` with
    attend's short route on, over the stage-1 flagship's checkpoint; the
    short kernels against their twins; a 2-user fp32 step GPU vs CPU; the
    switch-off / on A/B of the step and the beam search, the kernels' times
    and bound. Returns (amazon dict, kernel entries)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from rqvae_tpu_torch.data import dataset as dataset_lib
    from rqvae_tpu_torch.data.synthetic import synthetic_items, synthetic_sequences
    from rqvae_tpu_torch.models import generation
    from rqvae_tpu_torch.ops import attention as attn_ops
    from rqvae_tpu_torch.ops import flash_attention as fa
    from rqvae_tpu_torch.tokenizer import semids
    from rqvae_tpu_torch.train import checkpoint, optim
    from rqvae_tpu_torch.train import train_decoder as td
    from rqvae_tpu_torch.utils import amp
    from rqvae_tpu_torch.utils import config as config_lib
    from rqvae_tpu_torch.utils.logging import MetricsLogger
    from rqvae_tpu_torch.utils.tree import tree_leaves, tree_map

    counters = (fa.flash_attention_small_fwd, fa.flash_attention_small_bwd,
                fa.flash_attention_fwd, fa.flash_attention_bwd)
    names = [c.__name__ for c in counters]

    class Capture(MetricsLogger):
        def __init__(self):
            super().__init__(every=1)
            self.records = []

        def log(self, step, metrics, force=False):
            self.records.append({"step": step, "t": time.perf_counter(),
                                 "launches": [c.launches for c in counters],
                                 **{k: float(np.asarray(v)) for k, v in metrics.items()}})

    config = pathlib.Path(__file__).resolve().parent / "configs" / "decoder_amazon.json"
    overrides = ["dataset=SYNTHETIC", f"synthetic_n_items={N_ITEMS}",
                 f"synthetic_n_users={AMAZON_USERS}", f"vae_input_dim={INPUT_DIM}", f"seed={SEED}",
                 f"pretrained_rqvae_path={rq_ckpt}", f"save_dir_root={work}/decoder",
                 "log_every=100", "amp=true", f"partial_eval_every={AMAZON_ITERS}",
                 f"full_eval_every={AMAZON_ITERS}", f"save_model_every={AMAZON_ITERS}",
                 f"eval_batches={AMAZON_EVAL_BATCHES}"]
    cfg = config_lib.load_config(td.DecoderTrainConfig, str(config),
                                 overrides + [f"iterations={AMAZON_ITERS}"])
    model_cfg = cfg.retrieval_config(N_HIST)
    check(model_cfg.attn_dim // model_cfg.num_heads == 64 and model_cfg.n_layers == 8,
          f"Amazon decoder widths {model_cfg}")

    # ---- phase 20: train() with the short route on, the main path of this slice ----
    rec = {}
    real_small = attn_ops.flash_attention_small

    def record(q, k, v, *, k_mask=None, causal=False):
        out = real_small(q, k, v, k_mask=k_mask, causal=causal)
        kind = "decoder_self" if causal else ("encoder_self" if q.shape[2] == k.shape[2] else "cross")
        if out.requires_grad and kind not in rec:   # layer 0 of each kind, first step
            entry = rec[kind] = dict(q=q.detach(), k=k.detach(), v=v.detach(), k_mask=k_mask,
                                     causal=causal)
            out.register_hook(lambda g, e=entry: e.__setitem__("g", g.detach()))
        return out

    os.environ[SHORT_FLASH_ENV] = "1"
    try:
        for c in counters:
            c.launches = 0
        cap = Capture()
        t0 = time.perf_counter()
        params = td.train(cfg, logger=cap, device=dev)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        main_launches = dict(zip(names, (c.launches for c in counters)))
        saved = checkpoint.latest_step(cfg.save_dir_root)
        # the resumed call: 20 more steps; its first step records the operands
        attn_ops.flash_attention_small = record
        try:
            cap2 = Capture()
            params = td.train(config_lib.load_config(
                td.DecoderTrainConfig, str(config), overrides + [f"iterations={AMAZON_RESUME_ITERS}"]),
                logger=cap2, device=dev)
            torch.cuda.synchronize()
        finally:
            attn_ops.flash_attention_small = real_small
    finally:
        os.environ.pop(SHORT_FLASH_ENV, None)
    logs = [r for r in cap.records if "total_loss" in r]
    losses = [r["total_loss"] for r in logs]
    evals = [r for r in cap.records if "eval_loss" in r]
    gen_evals = [r for r in cap.records if "ndcg@10" in r]
    log(f"Amazon decoder train(): {train_s:.1f} s, losses {losses}, launches {main_launches}, "
        f"eval {evals}, generative eval {gen_evals}")
    check([r["step"] for r in logs] == [1] + list(range(100, AMAZON_ITERS + 1, 100)),
          f"Amazon log steps {[r['step'] for r in logs]}")
    check(all(math.isfinite(x) for x in losses), f"non-finite Amazon decoder loss {losses}")
    check(losses[-1] < losses[0], f"Amazon decoder loss did not fall: {losses}")
    per_step = [(b - a) / (logs[2]["step"] - logs[1]["step"])
                for a, b in zip(logs[1]["launches"], logs[2]["launches"])]
    check(per_step == [12, 12, 0, 0],
          f"launches per step {dict(zip(names, per_step))}: expected 12 short forward and 12 "
          "short backward (4 encoder self, 4 decoder self, 4 cross) and no flat flash")
    check(main_launches["flash_attention_fwd"] == 0 and main_launches["flash_attention_bwd"] == 0,
          f"flat flash kernels launched in the Amazon run: {main_launches}")
    check([r["step"] for r in evals] == [AMAZON_ITERS] and math.isfinite(evals[0]["eval_loss"]),
          f"Amazon eval loss {evals}")
    check([r["step"] for r in gen_evals] == [AMAZON_ITERS]
          and all(0.0 <= v <= 1.0 for k, v in gen_evals[0].items() if k.startswith(("h@", "ndcg"))),
          f"Amazon generative eval {gen_evals}")
    check(saved == AMAZON_ITERS - 1, f"Amazon decoder checkpoint step {saved}")
    resumed = [r["step"] for r in cap2.records if "total_loss" in r]
    state, _ = checkpoint.restore(cfg.save_dir_root, device="cpu")
    check(resumed[:1] == [AMAZON_ITERS + 1]
          and checkpoint.latest_step(cfg.save_dir_root) == AMAZON_ITERS + AMAZON_RESUME_ITERS - 1
          and state["opt_state"].count == AMAZON_ITERS + AMAZON_RESUME_ITERS,
          f"resume: logged steps {resumed}, checkpoint {checkpoint.latest_step(cfg.save_dir_root)}")
    del state
    step_ms = (logs[-1]["t"] - logs[1]["t"]) * 1e3 / (logs[-1]["step"] - logs[1]["step"])
    amazon = dict(
        train_step_ms=step_ms, train_examples_per_s=cfg.batch_size / (step_ms / 1e3),
        batch=cfg.batch_size, encoder_tokens=4 * N_HIST + 1, decoder_tokens=5, losses=losses,
        iterations=AMAZON_ITERS, wall_s=train_s, launches=main_launches,
        launches_per_step=dict(zip(names, per_step)),
        eval={k: v for k, v in evals[0].items() if k not in ("t", "launches")},
        generative_eval={k: v for k, v in gen_evals[0].items() if k not in ("t", "launches")},
        checkpoint_step=saved, resumed_first_step=resumed[0],
        users=AMAZON_USERS, items=N_ITEMS)

    # ---- phase 21: the short kernels against their twins ----
    check(set(rec) == {"encoder_self", "decoder_self", "cross"}
          and all("g" in e for e in rec.values()), f"recorded {sorted(rec)}")
    enc = rec["encoder_self"]
    b, h, n, dh = enc["q"].shape
    check((b, h, n, dh) == (cfg.batch_size, 8, 4 * N_HIST + 1, 64)
          and enc["q"].dtype == torch.bfloat16, f"recorded encoder operands {enc['q'].shape}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)

    def unit_rms(g):
        g = g.float()
        return g / g.pow(2).mean().sqrt()

    def rand(*shape):
        return torch.randn(shape, device=dev, generator=gen)

    def ragged(rows, nk):
        lengths = torch.randint(1, nk + 1, (rows,), device=dev, generator=gen)
        return torch.arange(nk, device=dev)[None] < lengths[:, None]

    holes = enc["k_mask"].clone()
    holes[:2] = False   # two rows whose every key is masked
    cross = rec["cross"]
    cases = [(kind, e["q"], e["k"], e["v"], unit_rms(e["g"]), e["k_mask"], e["causal"], None)
             for kind, e in rec.items()]
    cases += [("encoder_no_valid_key", enc["q"], enc["k"], enc["v"], unit_rms(enc["g"]), holes,
               False, slice(0, 2))]
    cases += [(f"decode_1x{t}", rand(b, h, 1, dh), rand(b, h, t, dh), rand(b, h, t, dh),
               rand(b, h, 1, dh), None, False, None) for t in (1, 2, 3, 4)]
    cases += [("beam_cross_32x81", rand(b, h, 32, dh), cross["k"], cross["v"], rand(b, h, 32, dh),
               cross["k_mask"], False, None),
              ("bucket_241", rand(16, h, 241, dh), rand(16, h, 241, dh), rand(16, h, 241, dh),
               rand(16, h, 241, dh), ragged(16, 241), False, None),
              ("causal_255_dh128", rand(4, h, 255, 128), rand(4, h, 255, 128), rand(4, h, 255, 128),
               rand(4, h, 255, 128), ragged(4, 255), True, None)]
    checks, errs = [], {"fwd": 0.0, "bwd": 0.0}
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        for case, q, k, v, g, km, causal, empty in cases:
            a = [t.to(dtype) for t in (q, k, v, g)]
            out, mm, inv = fa.flash_attention_small_fwd(*a[:3], k_mask=km, causal=causal)
            ref = fa.flash_attention_small_plain(*a[:3], k_mask=km, causal=causal)
            got = fa.flash_attention_small_bwd(*a, mm, inv, k_mask=km, causal=causal)
            want = fa.flash_attention_small_bwd_plain(*a, k_mask=km, causal=causal)
            torch.cuda.synchronize()
            row = {"dtype": str(dtype)[6:], "case": case, "shape": list(q.shape),
                   "nk": k.shape[2], "causal": causal, "tol": tol}
            for name, x, y in (("out", out, ref), ("dq", got[0], want[0]), ("dk", got[1], want[1]),
                               ("dv", got[2], want[2])):
                x, y = x.float(), y.float()
                row[name] = float((x - y).abs().max())
                row[name + "_max_abs"] = float(y.abs().max())
                check(bool(torch.isfinite(x).all()), f"small {case} {dtype} {name}: non-finite")
                check(torch.allclose(x, y, rtol=tol, atol=tol),
                      f"small {case} {dtype} {name} differs from the plain twin by {row[name]}")
            if empty is not None:
                check(float(out[empty].abs().max()) == 0.0, f"small {case}: masked rows not zero")
            if dtype == torch.bfloat16 and case == "encoder_self":
                errs = {"fwd": row["out"], "bwd": max(row["dq"], row["dk"], row["dv"])}
            checks.append(row)
            log(f"small vs plain {row}")
    del out, ref, got, want, cases

    # ---- phase 22: a 2-user fp32 Amazon step, GPU against CPU, switch on ----
    cpu = torch.device("cpu")
    vae_params, vae_cfg = td.load_frozen_rqvae(cfg, device=dev)
    items_x = torch.from_numpy(synthetic_items(N_ITEMS, INPUT_DIM, seed=SEED).x).to(dev)
    index = semids.precompute_corpus_ids(vae_params, vae_cfg, items_x)
    index_cpu = semids.CorpusIndex(index.cached_ids.to(cpu), index.sorted_keys.to(cpu),
                                   index.bases, index.codebook_size, index.n_distinct)
    users, _ = synthetic_sequences(N_ITEMS, n_users=BATCH, seed=SEED + 3)
    host_rng = np.random.default_rng(SEED)
    batch = dataset_lib.make_seq_batch(users.sample_batch(host_rng, BATCH, subsample=True),
                                       items_x.cpu().numpy(), with_features=False)
    cfg0 = dataclasses.replace(model_cfg, dropout=0.0, input_dropout=0.0)
    two = dataset_lib.to_device(type(batch)(*(a[:2] for a in batch)), dev)
    os.environ[SHORT_FLASH_ENV] = "1"
    try:
        before = fa.flash_attention_small_bwd.launches
        loss_g, _, grads_g = td.value_and_grad(td._make_microbatch_loss(cfg0, index, torch.float32),
                                               tree_map(lambda t: t.detach().clone(), params), two,
                                               None)
        gpu_bwd = fa.flash_attention_small_bwd.launches - before
        loss_c, _, grads_c = td.value_and_grad(
            td._make_microbatch_loss(cfg0, index_cpu, torch.float32), _to_device(params, cpu),
            type(two)(*(t.to(cpu) for t in two)), None)
    finally:
        os.environ.pop(SHORT_FLASH_ENV, None)
    check(gpu_bwd == 12, f"2-user fp32 step: {gpu_bwd} short backward launches, expected 12")
    loss_rel = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    leaf_rel = 0.0
    for x, y in zip(tree_leaves(grads_g), tree_leaves(grads_c)):
        err, scale = float((x.cpu() - y).abs().max()), float(y.abs().max())
        check(err <= 1e-3 * scale + 1e-12, f"Amazon GPU vs CPU gradient leaf differs: {err} of {scale}")
        leaf_rel = max(leaf_rel, err / scale if scale else 0.0)
    check(loss_rel <= 1e-4, f"Amazon GPU vs CPU fp32 loss differs by {loss_rel} relative")
    log(f"2-user fp32 Amazon step GPU vs CPU: loss {float(loss_c):.6f}, rel err {loss_rel:.2e}, "
        f"worst leaf {leaf_rel:.2e} of its max-abs")
    del grads_g, grads_c, vae_params

    # ---- phase 23: switch off / on in turns, the kernels' times and bound ----
    flat = dataset_lib.to_device(type(batch)(*(a[None] for a in batch)), dev)
    opt = optim.adamw(3e-4, 0.035)
    p_ab = tree_map(lambda t: t.detach().clone(), params)
    st_ab = opt.init(p_ab)
    step = td.make_train_step(model_cfg, opt, index, 1, torch.bfloat16, 4)
    step_gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    gen_params = amp.cast_floating(params, torch.bfloat16)
    tok = semids.tokenize_sequences(index, dataset_lib.to_device(batch, dev))
    tok = tok._replace(sem_ids_fut=None, token_type_ids_fut=None)

    def serve():
        return generation.generate_next_sem_ids(gen_params, model_cfg, index, tok, k=BEAMS,
                                                n_candidates=256)

    ab = {"step_ms": {"off": [], "on": []}, "generate_ms": {"off": [], "on": []},
          "step_launches": {}, "generate_launches": {}}
    n_steps = 10
    for mode in ("off", "on", "on", "off"):
        if mode == "on":
            os.environ[SHORT_FLASH_ENV] = "1"
        try:
            for _ in range(3):
                p_ab, st_ab, _ = step(p_ab, st_ab, flat, step_gen)
            torch.cuda.synchronize()
            for c in counters:
                c.launches = 0
            t0 = time.perf_counter()
            for _ in range(n_steps):
                p_ab, st_ab, m = step(p_ab, st_ab, flat, step_gen)
            torch.cuda.synchronize()
            ab["step_ms"][mode].append((time.perf_counter() - t0) * 1e3 / n_steps)
            ab["step_launches"][mode] = {nm: c.launches / n_steps for nm, c in zip(names, counters)}
            check(math.isfinite(float(m["total_loss"])), f"A/B step ({mode}): non-finite loss")
            serve()
            for c in counters:
                c.launches = 0
            ab["generate_ms"][mode].append(wall_ms(serve, 10))
            ab["generate_launches"][mode] = {nm: c.launches / 10 for nm, c in zip(names, counters)}
        finally:
            os.environ.pop(SHORT_FLASH_ENV, None)
    check(ab["step_launches"]["on"]["flash_attention_small_fwd"] == 12
          and ab["step_launches"]["on"]["flash_attention_small_bwd"] == 12
          and all(v == 0 for v in ab["step_launches"]["off"].values()),
          f"A/B launches per step {ab['step_launches']}")
    check(ab["generate_launches"]["on"]["flash_attention_small_fwd"] > 0
          and all(v == 0 for v in ab["generate_launches"]["off"].values()),
          f"A/B launches per beam search {ab['generate_launches']}")
    for key in ("step_ms", "generate_ms"):
        ab[key.replace("_ms", "_mean_ms")] = {k: sum(v) / len(v) for k, v in ab[key].items()}
    ab["train_examples_per_s"] = {k: BATCH / (v / 1e3) for k, v in ab["step_mean_ms"].items()}
    ab["queries_per_s"] = {k: BATCH / (v / 1e3) for k, v in ab["generate_mean_ms"].items()}
    log(f"Amazon switch off / on, in turns: {ab}")
    profile = {"off": _profile(lambda: step(p_ab, st_ab, flat, step_gen), top=12)}
    os.environ[SHORT_FLASH_ENV] = "1"
    try:
        profile["on"] = _profile(lambda: step(p_ab, st_ab, flat, step_gen), top=12)
    finally:
        os.environ.pop(SHORT_FLASH_ENV, None)
    del p_ab, st_ab, gen_params

    q, k, v, km = enc["q"], enc["k"], enc["v"], enc["k_mask"]
    g = unit_rms(enc["g"]).to(q.dtype)
    fwd_out, mm, inv = fa.flash_attention_small_fwd(q, k, v, k_mask=km)
    kernel_ms = {"fwd": cuda_ms(lambda: fa.flash_attention_small_fwd(q, k, v, k_mask=km), 50),
                 "bwd": cuda_ms(lambda: fa.flash_attention_small_bwd(q, k, v, g, mm, inv, k_mask=km),
                                50)}
    plain_ms = {"fwd": cuda_ms(lambda: fa.flash_attention_small_plain(q, k, v, k_mask=km), 20),
                "bwd": cuda_ms(lambda: fa.flash_attention_small_bwd_plain(q, k, v, g, k_mask=km), 20)}
    lib_mask = fa.mask_bias(km, b, n, dev)[:, None, None, :].to(q.dtype)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    sdpa_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(*leaves, attn_mask=lib_mask), 50)
    sdpa_fwd_bwd = cuda_ms(lambda: torch.autograd.backward(
        F.scaled_dot_product_attention(*leaves, attn_mask=lib_mask), g), 50)
    bnhd = [t.transpose(1, 2) for t in leaves]
    dense_mask = attn_ops.build_mask(n, n, k_mask=km)
    with torch.no_grad():
        dense_fwd = cuda_ms(lambda: attn_ops.sdpa(*bnhd, dense_mask), 50)
    dense_fwd_bwd = cuda_ms(lambda: torch.autograd.backward(
        attn_ops.sdpa(*bnhd, dense_mask), g.transpose(1, 2)), 50)
    device_ms = {
        "fwd": _device_ms(lambda: fa.flash_attention_small_fwd(q, k, v, k_mask=km), 20, "small_fwd"),
        "bwd": _device_ms(lambda: fa.flash_attention_small_bwd(q, k, v, g, mm, inv, k_mask=km), 20,
                          "small_bwd"),
        "sdpa_fwd": _device_ms(lambda: F.scaled_dot_product_attention(*leaves, attn_mask=lib_mask),
                               20),
        "sdpa_fwd_bwd": _device_ms(lambda: torch.autograd.backward(
            F.scaled_dot_product_attention(*leaves, attn_mask=lib_mask), g), 20)}
    del leaves, bnhd
    flops = 4 * b * h * n * n * dh
    elt = q.element_size()
    fwd_bytes = elt * 4 * b * h * n * dh + 4 * b * n + 8 * b * h * n
    bwd_bytes = elt * 7 * b * h * n * dh + 4 * b * n + 8 * b * h * n
    kernels = []
    for name, ops, nbytes, line, lib in (
            ("flash_attention_small_fwd", flops, fwd_bytes, 272, sdpa_fwd),
            ("flash_attention_small_bwd", flops * 10 // 4, bwd_bytes, 296, sdpa_fwd_bwd - sdpa_fwd)):
        t_ops, t_bytes = ops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
        short = name.rsplit("_", 1)[1]
        kernels.append(dict(
            name=name, route="cuda", source=f"rqvae_tpu_torch/csrc/{name}.cu",
            replaces=f"rqvae_tpu/ops/flash_attention.py:{line}",
            launches=main_launches[name], max_abs_err=errs[short], ms=kernel_ms[short],
            plain_ms=plain_ms[short], bound_ms=max(t_ops, t_bytes) * 1e3,
            bound_by="operations" if t_ops > t_bytes else "bytes", library_ms=lib))
    log(f"short kernels at B={b}, H={h}, N={n}, Dh={dh} {q.dtype}: {kernels}; device time "
        f"{device_ms}; dense sdpa {dense_fwd:.4f} / {dense_fwd_bwd - dense_fwd:.4f} ms")
    amazon.update(
        small_checks=checks,
        gpu_vs_cpu=dict(users=2, tokens=4 * N_HIST + 1, loss_rel_err=loss_rel,
                        worst_leaf_rel_err=leaf_rel),
        switch_ab=ab, train_profile=profile,   # one traced step, switch off and on
        attention_ms=dict(shape=[b, h, n, dh], kernel=kernel_ms, kernel_device=device_ms,
                          plain=plain_ms,
                          sdpa_library={"fwd": sdpa_fwd, "bwd": sdpa_fwd_bwd - sdpa_fwd},
                          dense_sdpa={"fwd": dense_fwd, "bwd": dense_fwd_bwd - dense_fwd}))
    return amazon, kernels


def _hold_stats(what, dtype, m, inv, ref_m, ref_inv) -> dict:
    """The forward's row statistics against the twin's: m to fp32 rounding of
    the scores (1e-5 of its max-abs over rows with an allowed key), inv to
    1e-3 relative in bf16 and 1e-5 in fp32; on rows with no allowed key
    (the twin's m <= -5e29) m = -1e30 and inv = 0 exactly."""
    import torch

    live = ref_m > 0.5 * -1e30
    row = {"dead_rows": int((~live).sum())}
    check(bool(torch.isfinite(m).all()) and bool(torch.isfinite(inv).all()),
          f"{what}: non-finite m or inv")
    check(bool((m[~live] == -1e30).all()) and bool((inv[~live] == 0).all()),
          f"{what}: rows with no allowed key must store m = -1e30 and inv = 0")
    if bool(live.any()):
        row["m"] = float((m - ref_m)[live].abs().max())
        row["m_max_abs"] = float(ref_m[live].abs().max())
        row["inv_rel"] = float(((inv - ref_inv) / ref_inv)[live].abs().max())
        check(row["m"] <= 1e-5 * row["m_max_abs"], f"{what}: m differs from the twin by {row['m']}")
        inv_tol = 1e-3 if dtype == torch.bfloat16 else 1e-5
        check(row["inv_rel"] <= inv_tol, f"{what}: inv differs from the twin by {row['inv_rel']} relative")
    return row


def _profile(fn, top: int = 8) -> dict:
    """One traced call of ``fn``: wall time, summed device time (the device's
    busy share of the wall time), the ops with the most device time, and
    every launch of the port's attention kernels (``flash::`` / ``small::``,
    whether or not they make the top)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    # device-side events only (kernels, copies): CPU ops would count them twice
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA), key=_dev_us, reverse=True)
    busy_us = sum(_dev_us(e) for e in events)
    return dict(wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
                device_idle_share=1.0 - busy_us / wall_us if busy_us else None,
                top_device_ops=[[e.key[:90], _dev_us(e) / 1e3, e.count] for e in events[:top]],
                attention_kernels=[[e.key[:90], _dev_us(e) / 1e3, e.count] for e in events
                                   if "flash::" in e.key or "small::" in e.key])


def _dev_us(event) -> float:
    return (getattr(event, "self_device_time_total", None)
            or getattr(event, "self_cuda_time_total", 0))


def _device_ms(fn, iters: int, key: str = "") -> float:
    """Device time of one call of ``fn``: the kernels whose name holds
    ``key`` (every kernel and copy when empty), summed over a torch.profiler
    trace of ``iters`` calls. Back-to-back CUDA-event timing of a call whose
    device work is shorter than its host-side enqueue measures the enqueue;
    this does not."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(_dev_us(e) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and key in e.key) / iters / 1e3


def _to_device(tree, device):
    from rqvae_tpu_torch.utils.tree import tree_map

    return tree_map(lambda t: t.to(device), tree)


def _near_ties(z, cbs, ids, rel: float = 1e-5, scale: str = "terms"):
    """Rows where, along the ``ids`` residual chain, the two smallest
    distances (float64) of some level differ by less than ``rel`` times a
    scale: ``"terms"``, the size of the terms an fp32 distance sums
    (||r||^2 + ||cb||^2 of the winner), since its rounding error grows with
    them and not with their difference; ``"d0"``, max(d0, 1) of the smallest
    distance (the rule before the stage-1 phases, reported beside it). There
    sums taken in another order may pick either code."""
    import torch

    res = z.double()
    near = torch.zeros(z.shape[0], dtype=torch.bool, device=z.device)
    for level, cb in enumerate(cbs.double()):
        dist = torch.cdist(res, cb) ** 2
        two = torch.topk(dist, 2, dim=1, largest=False).values
        win = cb[ids[:, level].long()]
        if scale == "terms":
            size = torch.sum(res * res, dim=1) + torch.sum(win * win, dim=1)
        else:
            size = torch.clamp(two[:, 0].abs(), min=1.0)
        near |= (two[:, 1] - two[:, 0]) < rel * size
        res = res - win
    return near


def _hold_rq_tokenize(z, cbs, beta, k_out):
    """Hold one rq_tokenize result against its plain twin on the same
    operands: ids equal except on rows that are near-ties under both scales
    of ``_near_ties``, sums / residual / loss to 1e-5 on the rows whose ids
    agree. Returns (rows with other ids, near-tie rows under the "terms" and
    the "d0" scale, max |err|)."""
    import torch

    from rqvae_tpu_torch.ops.quantize_kernels import rq_tokenize_plain

    p_out = rq_tokenize_plain(z, cbs, commitment_weight=beta)
    differ = (k_out.sem_ids != p_out.sem_ids).any(-1)
    near = _near_ties(z, cbs, p_out.sem_ids)
    near_d0 = _near_ties(z, cbs, p_out.sem_ids, scale="d0")
    check(not bool((differ & ~(near & near_d0)).any()),
          f"rq_tokenize ids differ off near-ties at {tuple(z.shape)}")
    same = ~differ
    err = 0.0
    for a, b in zip(k_out[1:], p_out[1:]):
        check(torch.allclose(a[same], b[same], rtol=1e-5, atol=1e-5),
              f"rq_tokenize sums / residual / loss differ from the plain version at {tuple(z.shape)}")
        err = max(err, float((a[same] - b[same]).abs().max()))
    return int(differ.sum()), int(near.sum()), int(near_d0.sum()), err


if __name__ == "__main__":
    sys.exit(main())
