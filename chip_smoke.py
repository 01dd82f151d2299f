#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: Amazon serving, ML-32M
decoder training and ML-32M serving, packed long-context decoder training,
stage-1 RQ-VAE training, Amazon decoder training through
``train_decoder.train`` over the stage-1 checkpoint, then the offline path
around training (raw files, preprocessing, export, test-split eval).

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
     count h@k / NDCG; check that rq_tokenize was launched and that
     children_window's Mask epilogue was launched 4 times (once a level of
     the beam search) and its Tokens epilogue never (counts zeroed just
     before, read just after);
  4. compare those kernels with their plain PyTorch twins on the main
     path's own inputs (both children_window epilogues bit-identical at
     every level of a rerun of the beam search whose beams equal the main
     path's; their events and device times beside the route the Mask
     epilogue replaces: the Tokens kernel, ``.long()``, ``zeros`` and
     ``scatter_``); check the beams (corpus members, finite, sorted) and
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
     k = 32, 256 candidates, through the flash forward kernel and 4 Mask
     launches; both children_window epilogues against their twins at every
     level of a rerun, and timed as in phase 4;
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
     every step must launch rq_quantize_train once (the fused route at every
     codebook volume: 400 launches);
 12. stage-1 stretch (``bench.py``'s ``rqvae_stretch``: embed 64, 4 x 2048
     codebooks, batch 1024, bf16 compute, 16 steps a chunk) on a 12,101 x 768
     N(0, 1) corpus after k-means priming: rq_quantize_train must launch once
     per step; ``id_diversity_metrics`` tokenizes the corpus through the
     K-tiled rq_tokenize at 4 x 2048 x 64; one chunk is traced;
 13. rq_quantize_train against its twin on the stretch step's and the
     flagship step's own encoder output and codebooks (ids equal off
     near-ties, values to 1e-5), its gradients (STE and rotation trick)
     against the plain per-level ``quantize.apply`` chain, each level's value
     set to its codeword as the fused route's is, to 1e-4 of each leaf's
     max-abs (the gap to the chain as it is, logged); rq_tokenize against its twin at 4 x 2048 x 64 on the
     corpus chunks the diversity metrics tokenized (their own ids) and on the
     step's rows; both quantizer kernels at ten odd shapes (B = 1, ragged
     rows and code blocks, L = 1, D = 3, 4, 16 and 128, D = 128 just under
     and just over the resident kernel's budget and through the cluster
     kernel's ring), equal codewords in several lanes (the resident kernel)
     or CTAs' slices (the cluster kernel): the lowest index, and a row of NaN
     (code 0); the library's launch plan against ``quantize_kernels.plan``
     (what the CPU tests emulate) at every shape, each plan resident on the
     card;
 14. two fp32 stage-1 steps at the Amazon widths, batch 64, GPU against CPU,
     each from the card's state, through both quantizer routes
     (``FUSED_TRAIN_MIN_CODEBOOK_VOLUME`` forced to 0 and to infinity): loss
     to 1e-5 relative, gradient leaves to 1e-4 of their max-abs;
 15. both quantizer kernels timed at both shapes (rq_quantize_train at the
     flagship's B = 64 x 3 x 256 x 32 and the stretch's 1024 x 4 x 2048 x 64,
     rq_tokenize at 4,096 rows of each stack): CUDA events, profiler device
     time, the twin, the bound and the plan; the step time of the fused and
     the plain route at both shapes (the module constant forced each way);
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
     cross, a causal 48 x 48, 208 x 96 and a causal 255 x 16 (the widest
     query sides of the backward's tiles kernel), 241 x 241 (the ML-32M
     short bucket), a causal 255 x 255 at Dh = 128, and the encoder's
     operands under three more masks: two batch rows with no valid key
     (also the cross attention's), keys 16-31 masked with the rest valid
     at random (a dead middle key tile), and every key valid: bf16 to 2e-2,
     fp32 to 1e-4, the backward fed the forward's own m and inv, the
     forward's row statistics held as in phase 7 (rows with no valid key:
     m = -1e30, inv = 0, output and gradients exactly 0); the bf16
     backward's dispatch rule as the CPU tests restate it
     (``small_bwd_route``) against the library's own at every Nq, Nk <= 255;
     the forward's C launcher called directly with an output view 4 bytes
     off 16-byte alignment: it must take the CUDA-core kernel (the gate
     the library exports, ``flash_attention.small_fwd_kernel_route``),
     match the twin, and leave the context usable (the aligned launch after
     it is gated to the live kernel and matches);
 22. a 2-user fp32 Amazon step with the switch on, GPU against CPU;
 23. the switch off / on / on / off in turns: the Amazon train step
     (batch 256) and beam search (256 users, k = 32); one traced step; the
     short kernels at each step shape (phase 21's layer-0 operands: 81 x 81,
     causal 5 x 5, 5 x 81): CUDA events, profiler device time, the bound
     (each operand at its own length, K / V over the valid keys, the
     products over the allowed pairs, the valid-key share beside it), the
     twin and
     ``F.scaled_dot_product_attention`` under the same mask (additive bias,
     causal cut), and the launch-weighted sum of a step (4 launches of each
     shape); the forward on the encoder's operands with every key valid,
     beside its bound; the forward kernel's launch plan at each step shape;
     the first short-forward call of each shape in one beam search with the
     switch on (81 x 81, the beam-folded 32 x 81, the decode steps' 1 x t),
     held against the twin and timed beside its bound; the dense ``sdpa``
     at 81 x 81; each flash kernel library's count of
     ``cudaFuncSetAttribute`` calls, which must be at least 1 and must not
     grow over further calls;
 24. the width rule of the kernel routes (run after phase 4): ``attend`` at
     Dh = 256 on a span, a short (switch on) and a flat shape, and the
     RQ-VAE's two quantizer routes at embed_dim = 256 (codebook volume
     65,536), each on the card against the same call on the CPU (values
     and gradients to 1e-5 of their max-abs; ids equal off near-ties; the
     training loss to 1e-5 relative and gradient leaves to 1e-4 of their
     max-abs), and a Gumbel-softmax training forward at embed_dim = 32
     (a finite loss): shapes wider than the kernels take and the Gumbel
     estimator go the dense and plain routes, and no kernel wrapper
     launches;
 25. the offline path (run after phase 23, ``RQVAE_TPU_SHORT_FLASH``
     unset): a raw Amazon Beauty split of the real one's shape written from
     the seed (``datamaps.json``, ``meta.json.gz`` for 12,101 items,
     ``sequential_data.txt`` for 22,363 users, 5-core histories, ~198,500
     interactions), ``amazon.process`` with the hashed stub encoder,
     ``train_decoder.train`` on ``configs/decoder_amazon.json`` with
     ``dataset=AMAZON`` over those artifacts and phase 11's checkpoint (100
     steps), both models exported and reloaded through ``models/io`` (equal
     corpus IDs, equal beams on one batch), then
     ``run_eval.evaluate_checkpoint(split="test")`` over all 22,363 users,
     counted: rq_tokenize 3 launches (one a 4,096-row chunk), the
     children_window Mask epilogue 4 a batch (352) and Tokens none;
     rq_tokenize against its twin on the stub corpus (ids equal off
     near-ties, the index's IDs the kernel's), both children_window
     epilogues bit-identical to their twins at every level of one batch, a
     64-user fp32 eval (exhaustive candidates) on the card against the CPU
     (metrics equal), h@k and NDCG in [0, 1]; the preprocessing, corpus
     tokenization, export / reload and eval times and one traced 256-user
     eval.

Phases 26-28 (the kernel switch, data parallelism, observability) are
described at ``_switch_ab``, ``_distributed`` and ``_observability``;
phase 29 (tensor parallelism: two ranks of this script, ``--tp-worker``,
share the card over gloo at mesh (1, 2)) at ``_tensor_parallel``.

Phases 30-33 run the shipped MovieLens configs through the entry points, on
raw fixtures of MovieLens' shape written from the seed and preprocessed by
``movielens.process`` (``_movielens_data``: ML-32M cut to a tenth of its
users and ratings, ML-1M whole). Phase 31 (``_ml_stage1``:
``configs/rqvae_ml32m.json`` and ``rqvae_ml1m.json`` through
``train_rqvae.train``) runs first, because its ML-32M RQ-VAE feeds phase 30
(``_tp4``: ML-32M's 6 heads on four ranks at mesh (1, 4), whole on every
rank), phase 32 (``_ml_decoder``: ``configs/decoder_ml32m.json`` as
shipped through ``train_decoder.train``) and phase 33 (``_ml_branches``:
``train()``'s packed and accumulating branches); its ML-1M RQ-VAE feeds
phase 34 (``_ml1m_decoder``: ``configs/decoder_ml1m.json`` as shipped
through ``train_decoder.train``). Every shipped decoder config trains in
fp32, so phases 32-34 run the fp32 tensor-core route of the flat and span
kernels (three TF32 products): each checks that every flat / span launch of
its ``train()`` took that route and holds and times those kernels on its
own layer-0 operands (``_fp32_row``), beside the twin, fp32
``F.scaled_dot_product_attention`` and both bounds.

TF32 is switched off for matmuls and cuDNN, so fp32 work runs in fp32.
``RQVAE_TPU_SHORT_FLASH`` is unset for phases 1-19, so they take
``attend``'s default routes.

Prints the nvidia-smi line, a ``{"serving": {...}}`` line, a
``{"train": {...}}`` line (the packed step under its ``packed`` key, the
Amazon decoder under ``amazon``), a ``{"train_rqvae": {...}}`` line, a
``{"wide": {...}}`` line (phase 24), an ``{"offline": {...}}`` line (phase
25), the ``{"dispatch"}``, ``{"distributed"}``, ``{"observability"}`` and
``{"tensor_parallel"}`` lines (phases 26-29), a ``{"movielens": {...}}``
line (phases 30-34), the nvidia-smi line again, a ``{"kernels": [...]}``
line (nine entries; rq_tokenize's and children_window's also carry phase
25's launches as ``offline_launches``; phases 30-34's shapes are added to
the entries' ``at_shapes``, the fp32 kernels' rows under an ``fp32`` key)
and, last, ``{"ok": true, "device": {...}}``.
Any failure exits non-zero before the last line; so does a machine without
a GPU. Run from the repository root: ``python3 chip_smoke.py``.
"""
from __future__ import annotations

import contextlib
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
BEAUTY_ACTIONS_PER_USER = 198502 / 22363    # Amazon Beauty (TIGER, Table 1)
OFFLINE_ITERS = 100     # phase 25's decoder steps before its eval
OFFLINE_CPU_USERS = 64  # phase 25's fp32 eval on the card and on the CPU

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
FP32_FLOP_PER_S = 67e12     # H100 SXM fp32, outside the tensor cores
BF16_FLOP_PER_S = 989e12    # H100 SXM bf16 tensor cores, dense
TF32_FLOP_PER_S = 495e12    # H100 SXM TF32 tensor cores, dense
FP32_FLOP_PER_S = 67e12     # H100 SXM fp32 outside the tensor cores
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

    if sys.argv[1:2] in (["--dp-worker"], ["--tp-worker"]):   # a rank of phase 27 or 29
        globals().update(json.loads(sys.argv[5]))   # the launching run's sizes
        worker = _dp_worker if sys.argv[1] == "--dp-worker" else _tp_worker
        return worker(*sys.argv[2:5], sys.argv[6])
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device visible")
        return 1

    from rqvae_tpu_torch.evaluate import metrics
    from rqvae_tpu_torch.models import generation, rqvae
    from rqvae_tpu_torch.ops import _cuda_build
    from rqvae_tpu_torch.ops.children_window import children_window, children_window_mask
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
    rq_params, rq_cfg, corpus, dec_params, dec_cfg, seq_batch = _amazon_serving_setup(dev)
    torch.cuda.synchronize()

    # ---- the main path, counted ----
    rq_tokenize.launches = 0
    children_window_mask.launches = 0
    children_window.launches = 0
    t0 = time.perf_counter()
    index = semids.precompute_corpus_ids(rq_params, rq_cfg, corpus)
    tok = semids.tokenize_sequences(index, seq_batch)
    out = generation.generate_next_sem_ids(dec_params, dec_cfg, index, tok, k=BEAMS,
                                           n_candidates=256)
    counts = metrics.batch_hit_counts(tok.sem_ids_fut, out.sem_ids, ks=(1, 5, 10))
    torch.cuda.synchronize()
    first_run_ms = (time.perf_counter() - t0) * 1e3
    launches = {"rq_tokenize": rq_tokenize.launches,
                "children_window_mask": children_window_mask.launches,
                "children_window": children_window.launches}
    log(f"main path launches: {launches}")
    check(launches["rq_tokenize"] > 0, "rq_tokenize was not launched on the main path")
    # one beam search: the Mask epilogue once a level (4), the Tokens epilogue never
    check(launches["children_window_mask"] == 4 and launches["children_window"] == 0,
          f"children_window launches on the main path: {launches}")
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
    tok_main = _rq_timed("rq_tokenize", lambda: rq_tokenize(z0, cbs),
                         lambda: rq_tokenize_plain(z0, cbs), z0, cbs)
    kernels.append(dict(
        name="rq_tokenize", route="cuda", source="rqvae_tpu_torch/csrc/rq_tokenize.cu",
        replaces="rqvae_tpu/ops/quantize_pallas.py:48",
        launches=launches["rq_tokenize"], max_abs_err=rq_err,
        ms=tok_main["ms"], device_ms=tok_main["device_ms"], plain_ms=tok_main["plain_ms"],
        bound_ms=tok_main["bound_ms"], bound_by=tok_main["bound_by"], library_ms=None,
        at_shapes={"amazon_4096x3x256x32": tok_main},
    ))

    # the beam search's own children_window operands: rerun it (same weights
    # and inputs) with the Mask wrapper's calls recorded
    k_tok = index.codebook_size
    with _record_children_window(semids) as cw_inputs:
        again = generation.generate_next_sem_ids(dec_params, dec_cfg, index, tok, k=BEAMS,
                                                 n_candidates=256)
    check(bool((again.sem_ids == out.sem_ids).all()), "rerun beams differ from the main path's")
    log("rerun beams equal to the main path's")
    check([a[1].shape[0] for a in cw_inputs] == [1] + [BATCH * BEAMS] * 3,
          f"children_window rows per step {[a[1].shape[0] for a in cw_inputs]}")
    cw_err = _hold_children_window(cw_inputs, k_tok)
    log("children_window Tokens and Mask vs plain: identical at levels 0..3")
    log(f"children_window Mask vs plain at wide K (bits set): {_hold_children_window_wide_k(dev)}")
    cw_amazon = _cw_timed(cw_inputs[1:], k_tok)
    log(f"children_window at {BATCH * BEAMS} rows: {cw_amazon}")
    kernels.append(dict(
        name="children_window", route="cuda", source="rqvae_tpu_torch/csrc/children_window.cu",
        replaces="rqvae_tpu/ops/children_window.py:33",
        launches=launches["children_window_mask"], max_abs_err=float(cw_err),
        ms=cw_amazon["mask"]["ms"], device_ms=cw_amazon["mask"]["device_ms"],
        plain_ms=cw_amazon["mask"]["plain_ms"], bound_ms=cw_amazon["mask"]["bound_ms"],
        bound_by="bytes", library_ms=None,
        at_shapes={f"amazon_{BATCH * BEAMS}": cw_amazon},
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
    del rq_params, corpus, index, dec_params, params32, chunks, cw_inputs, out, again

    # ---- phase 24: the width rule of the kernel routes ----
    wide = _wide(dev)

    # ---- ML-32M: decoder training, then long-context serving ----
    train, ml_serving, flash_kernels = _ml32m(dev)
    kernels[1]["at_shapes"][f"ml32m_{ML_GEN_BATCH * BEAMS}"] = ml_serving.pop("children_window")
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
        kernels[0]["at_shapes"].update(train_rqvae["rq_tokenize_at_shapes"])
        kernels += stage1_kernels
        torch.cuda.empty_cache()

        # ---- the Amazon decoder through train(), over the flagship's checkpoint ----
        train["amazon"], small_kernels = _amazon_decoder(dev, rq_ckpt, work)
        kernels += small_kernels
        torch.cuda.empty_cache()

        # ---- phase 25: the offline path around training, over the same checkpoint ----
        offline = _offline(dev, rq_ckpt, work)
        for entry in kernels[:2]:
            entry["offline_launches"] = offline["eval"]["launches"][
                "rq_tokenize" if entry["name"] == "rq_tokenize" else "children_window_mask"]
        torch.cuda.empty_cache()

        # ---- phases 26-28: the kernel switch, data parallelism, observability ----
        dispatch_ab = _switch_ab(dev, rq_ckpt, work)
        torch.cuda.empty_cache()
        distributed = _distributed(dev, rq_ckpt, work)
        torch.cuda.empty_cache()
        observability = _observability(dev, rq_ckpt, work)
        torch.cuda.empty_cache()
        # ---- phase 29: tensor parallelism, two ranks on the card over gloo ----
        tensor_parallel = _tensor_parallel(dev, rq_ckpt, work, smi)
        torch.cuda.empty_cache()
        # ---- phases 30-33: the shipped MovieLens configs through the entry
        # points; phase 31 runs first, since its ML-32M RQ-VAE feeds the others ----
        roots = {}
        roots["ml32m"], roots["ml1m"], ml_data = _movielens_data(work)
        ml_stage1, rq32_ckpt, rq1m_ckpt, rq_shapes = _ml_stage1(dev, work, roots)
        torch.cuda.empty_cache()
        tp4 = _tp4(dev, work, roots, rq32_ckpt, smi)
        torch.cuda.empty_cache()
        ml_decoder, long_row = _ml_decoder(dev, work, roots, rq32_ckpt)
        torch.cuda.empty_cache()
        ml_branches, span_shape, packed_row = _ml_branches(dev, work, roots, rq32_ckpt)
        torch.cuda.empty_cache()
        # ---- phase 34: decoder_ml1m.json through train() ----
        ml1m_decoder, ml1m_row = _ml1m_decoder(dev, work, roots, rq1m_ckpt)
    movielens = dict(data=ml_data, tp_1x4=tp4, stage1=ml_stage1, decoder_ml32m=ml_decoder,
                     branches=ml_branches, decoder_ml1m=ml1m_decoder)
    by_name = {e["name"]: e for e in kernels}
    for name, shapes in rq_shapes.items():
        by_name[name]["at_shapes"].update(shapes)
    for d in ("fwd", "bwd"):   # the whole heads of one rank at (1, 4)
        by_name[f"flash_attention_{d}"].setdefault("at_shapes", {})["ml32m_tp1x4_rank0"] = {
            dt: tp4["ranks"][0]["ml32m"][dt]["twins"] for dt in ("fp32", "bf16")}
        by_name[f"flash_attention_spans_{d}"].setdefault("at_shapes", {})[
            "ml32m_packed_train_layer0"] = span_shape
    # the fp32 tensor-core kernels at the shipped decoder configs' shapes:
    # each direction's own numbers beside the phase's operands and bounds
    for name, shape, row in (("flash_attention", "ml1m_flat_layer0", ml1m_row),
                             ("flash_attention", "ml32m_long_bucket_layer0", long_row),
                             ("flash_attention_spans", "ml32m_packed_layer0", packed_row)):
        for d in ("fwd", "bwd"):
            fp32 = {k: v for k, v in row[d].items()}
            fp32.update(route=row["routes"][d], launches_per_step=row["launches_per_step"],
                        max_abs_err=row["max_abs_err"], shape=row["shape"],
                        **{k: v for k, v in row["bounds"][d].items()},
                        pairs=row["bounds"]["pairs"], dense_pairs=row["bounds"]["dense_pairs"])
            by_name[f"{name}_{d}"].setdefault("at_shapes", {})[shape] = {"fp32": fp32}
    print(json.dumps({"serving": serving}), flush=True)
    print(json.dumps({"train": train}), flush=True)
    print(json.dumps({"train_rqvae": train_rqvae}), flush=True)
    print(json.dumps({"wide": wide}), flush=True)
    print(json.dumps({"offline": offline}), flush=True)
    print(json.dumps({"dispatch": dispatch_ab}), flush=True)
    print(json.dumps({"distributed": distributed}), flush=True)
    print(json.dumps({"observability": observability}), flush=True)
    print(json.dumps({"tensor_parallel": tensor_parallel}), flush=True)
    print(json.dumps({"movielens": movielens}), flush=True)
    # the card and the kernels once more, last, where a capture of the
    # output's tail keeps them
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _amazon_serving_setup(dev):
    """Phase 3's seeded set-up: the RQ-VAE (weights and the 12,101 x 768
    corpus), the bf16 decoder and 256 users' 20-item histories. Returns
    (rq_params, rq_cfg, corpus, dec_params, dec_cfg, seq_batch)."""
    import torch

    from rqvae_tpu_torch.data.schemas import SeqBatch
    from rqvae_tpu_torch.models import quantize, retrieval, rqvae
    from rqvae_tpu_torch.utils import amp

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
    return rq_params, rq_cfg, corpus, dec_params, dec_cfg, seq_batch


def _wide(dev):
    """Phase 24: shapes wider than the kernels take go the plain routes.
    ``attend`` at Dh = 256 on a span, a short (switch on) and a flat shape,
    and the RQ-VAE's two quantizer routes at embed_dim = 256 (the fused
    training route but for the width rule), each on the card against the
    same call on the CPU, and a Gumbel-softmax training forward at
    embed_dim = 32 (the plain loop); no kernel wrapper may launch."""
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
    # Gumbel-softmax training at the Amazon widths keeps the plain per-level
    # loop too (its noise comes from the card's generator, so it is not held
    # against the CPU)
    gcfg = dataclasses.replace(cfg, embed_dim=32,
                               codebook_mode=quantize.QuantizeForwardMode.GUMBEL_SOFTMAX)
    gparams = rqvae.init(torch.Generator().manual_seed(SEED + 25), gcfg, device=dev)
    gloss = rqvae.forward(gparams, gcfg, clean.to(dev), gumbel_t=0.2, training=True,
                          generator=torch.Generator(device=dev).manual_seed(SEED + 25)).loss
    check(bool(torch.isfinite(gloss)), f"Gumbel training forward at D = 32: loss {float(gloss)}")
    out["gumbel_d32"] = dict(rows=int(clean.shape[0]), loss=float(gloss))
    launches = {w.__name__: w.launches for w in wrappers}
    check(not any(launches.values()),
          f"a kernel launched on a shape wider than it takes, or under Gumbel: {launches}")
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
    from rqvae_tpu_torch.ops.children_window import children_window, children_window_mask
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
            row = {"dtype": str(dtype)[6:], "case": case, "tol": tol,
                   "routes": [fa.kernel_route(fa.flash_attention_fwd, *a[:3], out),
                              fa.kernel_route(fa.flash_attention_bwd, *a)]}
            # Dh = 64 on aligned rows takes the tensor cores: bf16 on wgmma, fp32 as
            # three TF32 products; the unaligned views the CUDA cores
            want_route = ("cuda_cores" if case == "unaligned" else
                          "wgmma_bf16" if dtype == torch.bfloat16 else "tf32x3")
            check(row["routes"] == [want_route] * 2, f"flash {case} {dtype} routes {row['routes']}")
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
    children_window_mask.launches = 0
    children_window.launches = 0
    out = serve()
    torch.cuda.synchronize()
    serve_launches = {"flash_attention_fwd": fa.flash_attention_fwd.launches,
                      "children_window_mask": children_window_mask.launches,
                      "children_window": children_window.launches}
    check(serve_launches["flash_attention_fwd"] == 4,
          f"ML-32M serving: {serve_launches} (the encoder's 4 layers take the flash kernel)")
    check(serve_launches["children_window_mask"] == 4 and serve_launches["children_window"] == 0,
          f"ML-32M serving: {serve_launches} (one Mask launch a level, no Tokens launch)")
    check(bool(torch.isfinite(out.log_probas).all()), "ML-32M serving: non-finite log-probas")
    live = out.log_probas > generation.INVALID_PENALTY / 2
    check(bool(semids.exists_prefix(index, out.sem_ids)[live].all()),
          "ML-32M serving: an unpenalised beam is not a corpus item")
    with _record_children_window(semids) as cw_inputs:
        again = serve()
    check(bool((again.sem_ids == out.sem_ids).all()), "ML-32M serving: rerun beams differ")
    check([a[1].shape[0] for a in cw_inputs] == [1] + [ML_GEN_BATCH * BEAMS] * 3,
          f"ML-32M children_window rows per step {[a[1].shape[0] for a in cw_inputs]}")
    _hold_children_window(cw_inputs, index.codebook_size)
    log("ML-32M children_window Tokens and Mask vs plain: identical at levels 0..3")
    ml_gen_ms = wall_ms(serve, 5)
    ml_serving = dict(generate_ms=ml_gen_ms, queries_per_s=ML_GEN_BATCH / (ml_gen_ms / 1e3),
                      batch=ML_GEN_BATCH, encoder_tokens=n_tok + 1, beams=BEAMS,
                      corpus_items=ML_ITEMS, launches=serve_launches,
                      live_beams=int(live.sum()))
    log(f"ML-32M serving: {ml_serving}")
    ml_serving["children_window"] = _cw_timed(cw_inputs[1:], index.codebook_size)
    log(f"children_window at {ML_GEN_BATCH * BEAMS} rows: {ml_serving['children_window']}")
    del cw_inputs, again
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
            row = {"dtype": str(dtype)[6:], "case": case, "nq": nq, "tol": tol,
                   "routes": [fa.kernel_route(fa.flash_attention_spans_fwd, *a[:3], out),
                              fa.kernel_route(fa.flash_attention_spans_bwd, *a)]}
            want_route = "wgmma_bf16" if dtype == torch.bfloat16 else "tf32x3"
            check(row["routes"] == [want_route] * 2, f"spans {case} {dtype} routes {row['routes']}")
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
    from rqvae_tpu_torch.utils.tree import tree_map

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
    check(flag_launches == {"rq_tokenize": n_chunks, "rq_quantize_train": RQ_ITERS},
          f"flagship launches {flag_launches}: the eval tokenizes through rq_tokenize, and every "
          f"step takes the fused route (volume {acfg.codebook_size * acfg.embed_dim}) through "
          "one rq_quantize_train launch")
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

    # ---- phase 13: the kernels against their twins ----
    w_read = torch.randn((128, 16), generator=gen, device=dev) / 8.0

    def record_fused(model_cfg, p, data, batch, dtype):
        """One device-chunk step of ``model_cfg`` on ``p`` (left as it was),
        with rq_quantize_train's operands recorded."""
        rec = {}
        real_fused = rqvae.rq_quantize_train

        def record(x, cbs, mode, beta):
            rec.setdefault("x", x.detach().clone())
            rec.setdefault("cbs", cbs.detach().clone())
            return real_fused(x, cbs, mode, beta)

        o = optim.adamw(5e-4, 0.01)
        p = tree_map(lambda t: t.detach().clone(), p)
        rqvae.rq_quantize_train = record
        try:
            one = tr.make_device_chunk(model_cfg, o, 1, dtype, batch, 1)
            one(p, o.init(p), data, gen, 0.2)
        finally:
            rqvae.rq_quantize_train = real_fused
        torch.cuda.synchronize()
        check(rec["x"].dtype == dtype and tuple(rec["x"].shape) == (batch, model_cfg.embed_dim),
              f"recorded encoder output {rec['x'].dtype} {tuple(rec['x'].shape)}")
        return rec["x"].float().contiguous(), rec["cbs"].float().contiguous()

    def hold_train(xs, cbs, label):
        """rq_quantize_train on the card against its twin (ids equal off
        near-ties, values to 1e-5) and its gradients (STE and rotation
        trick) against the plain per-level quantize.apply chain (1e-4 of
        each leaf's max-abs), on the rows without a near-tie.

        The fused route's value of a level is its codeword, as the JAX
        kernel's is; the chain's rotation-trick value is the codeword times
        |res| / (|res| + 1e-6), the scale's eps. Every later residual, and so
        every later level's codebook gradient 2 (emb - res), moves by ~1e-6
        in norm, which at a trained model's small deep residuals is some
        1e-4 of the leaf's max-abs. So the chain held against the route sets
        each level's value to its codeword (``x + sg(codeword - x)`` on the
        estimator's output: its gradients unchanged); the gap to the chain
        as it is is logged as ``model_chain_gap``."""
        with torch.no_grad():
            k_out = qk.rq_quantize_train(xs, cbs, "ROTATION_TRICK", 0.25)
            p_out = qk.rq_quantize_train_plain(xs, cbs, commitment_weight=0.25)
        near = _near_ties(xs, cbs, p_out.sem_ids)
        differ = (k_out.sem_ids != p_out.sem_ids).any(-1)
        check(not bool((differ & ~near).any()), f"rq_quantize_train ids differ off near-ties ({label})")
        same = ~differ
        err = 0.0
        for name in ("embeddings", "residuals", "quantize_loss"):
            a, b = getattr(k_out, name)[same], getattr(p_out, name)[same]
            check(torch.allclose(a, b, rtol=1e-5, atol=1e-5),
                  f"rq_quantize_train {name} differs from the plain twin ({label})")
            err = max(err, float((a - b).abs().max()))
        keep = ~near
        w = w_read[:xs.shape[1]]

        def readout(embs, q_loss):
            z = torch.sum(embs, dim=-1) @ w
            return torch.mean(torch.sum(z * z, dim=-1)) + torch.mean(q_loss)

        grads = {}
        for mode in ("STE", "ROTATION_TRICK"):
            xa, ca = xs[keep].clone().requires_grad_(True), cbs.clone().requires_grad_(True)
            o = qk.rq_quantize_train(xa, ca, mode, 0.25)
            got = torch.autograd.grad(readout(o.embeddings, o.quantize_loss), (xa, ca))
            want = {}
            for snap in (True, False):
                xb, cb_ = xs[keep].clone().requires_grad_(True), cbs.clone().requires_grad_(True)
                res, embs, q_loss = xb, [], 0.0
                for level in range(cbs.shape[0]):
                    q = quantize.apply({"codebook": cb_[level]}, res,
                                       mode=quantize.QuantizeForwardMode[mode],
                                       commitment_weight=0.25, training=True)
                    q_loss = q_loss + q.loss
                    out = q.embeddings
                    if snap:
                        out = out + (cb_[level][q.ids.long()] - out).detach()
                    res = res - out
                    embs.append(out)
                want[snap] = torch.autograd.grad(readout(torch.stack(embs, dim=-1), q_loss),
                                                 (xb, cb_))
            row = {"model_chain_gap": {}}
            for i, name in enumerate(("x", "codebooks")):
                a, b, c = got[i], want[True][i], want[False][i]
                e, scale = float((a - b).abs().max()), float(b.abs().max())
                check(e <= 1e-4 * scale, f"rq_quantize_train {mode} d{name} ({label}): {e} of {scale}")
                row[name] = e / scale
                row["model_chain_gap"][name] = float((a - c).abs().max()) / float(c.abs().max())
            grads[mode] = row
        held = dict(rows=int(xs.shape[0]), id_rows_differ=int(differ.sum()),
                    near_tie_rows=int(near.sum()), max_abs_err=err, grad_err_over_max_abs=grads)
        log(f"rq_quantize_train vs plain ({label}): {held}")
        return held

    # the stretch step's own operands, and the flagship step's (the fused
    # route at the Amazon widths, batch 64, fp32)
    xs, cbs = record_fused(mcfg, params, corpus, STRETCH_BATCH, torch.bfloat16)
    train_checks = {"stretch_1024x4x2048x64": hold_train(xs, cbs, "stretch step")}
    train_err = train_checks["stretch_1024x4x2048x64"]["max_abs_err"]
    amazon_data = torch.from_numpy(synthetic_items(N_ITEMS, INPUT_DIM, seed=SEED).x).to(dev)
    xf, cbf = record_fused(acfg, flag_params, amazon_data, cfg.batch_size, torch.float32)
    train_checks["flagship_64x3x256x32"] = hold_train(xf, cbf, "flagship step")
    flag_err = train_checks["flagship_64x3x256x32"]["max_abs_err"]

    # the K-tiled rq_tokenize at 4 x 2048 x 64: the ids that the diversity
    # metrics got on each corpus chunk (4,096 rows twice, then the 3,909-row
    # tail), and the stretch step's own 1,024 rows
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
    log(f"rq_tokenize vs plain at 4x2048x64: {tok_checks}")

    # odd shapes the main paths do not give: B = 1; B not a multiple of a
    # CTA's rows with K not a multiple of a lane block or a slice; L = 1; D =
    # 3 (padded to 4), 16 and 128; D = 128 just under and just over the
    # resident kernel's budget, and through the cluster kernel's ring; a
    # part-filled last cluster
    odd_shapes = ((37, 2, 32, 16), (100, 3, 300, 128), (513, 2, 1000, 64), (5, 1, 7, 3),
                  (1, 3, 256, 32), (37, 2, 301, 16), (70, 1, 200, 4), (40, 3, 128, 128),
                  (40, 3, 192, 128), (40, 3, 520, 128))
    odd_checks = {}
    with torch.no_grad():
        for b_odd, n_lv, k_odd, d_odd in odd_shapes:
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
        # equal codewords in several CTAs' slices: the lowest index, in both
        # kernels; a row of NaN: code 0 at every level
        for k_tie, copies in ((256, (5, 130, 200)), (2048, (17, 700, 1500, 2040))):
            cb_tie = torch.randn((2, k_tie, 32), generator=gen, device=dev) * 0.7
            cb_tie[0, list(copies[1:])] = cb_tie[0, copies[0]].clone()
            x_tie = cb_tie[0, copies[0]][None].repeat(64, 1) + 1e-3 * torch.randn(
                (64, 32), generator=gen, device=dev)
            x_tie[7] = float("nan")
            tie_plan = qk.kernel_plan("rq_tokenize", 64, 2, k_tie, 32)
            # resident: copies in several lanes of a warp; cluster: in several CTAs
            slices = {c % 32 if tie_plan["resident"] else c // tie_plan["slice"] for c in copies}
            check(len(slices) > 1, f"tie copies {copies} all with one owner under {tie_plan}")
            for label, ids in (("rq_tokenize", qk.rq_tokenize(x_tie, cb_tie).sem_ids),
                               ("rq_quantize_train",
                                qk.rq_quantize_train(x_tie, cb_tie, "STE", 0.25).sem_ids)):
                live = torch.ones(64, dtype=torch.bool, device=dev)
                live[7] = False
                check(bool((ids[live, 0] == copies[0]).all()),
                      f"{label}: equal codewords at {copies} do not give the lowest index")
                check(bool((ids[7] == 0).all()), f"{label}: a row of NaN does not take code 0")
            odd_checks[f"ties K={k_tie}"] = dict(copies=list(copies), owners=sorted(slices),
                                                resident=tie_plan["resident"])
    log(f"quantizer kernels vs plain at odd shapes: {odd_checks}")

    # the launch plan: the library's against the restatement the CPU tests
    # emulate, at every shape above and the timed ones; each plan resident
    plans = {}
    for shape in odd_shapes + ((64, 3, 256, 32), (4096, 3, 256, 32), (1024, 4, 2048, 64),
                               (4096, 4, 2048, 64), (100, 3, 300, 4)):
        d4 = shape[3] + (-shape[3] % 4)
        props = torch.cuda.get_device_properties(dev)
        want = qk.plan(*shape[:3], d4, sms=props.multi_processor_count,
                       optin=getattr(props, "shared_memory_per_block_optin", qk.H100_OPTIN))
        for name in ("rq_tokenize", "rq_quantize_train"):
            got = qk.kernel_plan(name, *shape[:3], d4)
            check({f: got[f] for f in qk.PLAN_FIELDS} == want and got["clusters"] > 0,
                  f"{name} plan at {shape}: the library's {got}, the restatement's {want}")
        plans["x".join(map(str, shape))] = got
    log(f"quantizer launch plans: {plans}")
    kernel_checks = dict(rq_quantize_train=train_checks, rq_tokenize_4x2048x64=tok_checks,
                         odd_shapes=odd_checks, plans=plans)

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

    gpu_cpu = {}
    default_volume = rqvae.FUSED_TRAIN_MIN_CODEBOOK_VOLUME
    opt = optim.adamw(5e-4, 0.01)
    for route, volume in (("plain", float("inf")), ("fused", 0)):
        rqvae.FUSED_TRAIN_MIN_CODEBOOK_VOLUME = volume
        try:
            # both devices take each step from the card's state: AdamW's
            # first update is near lr * sign(g), so a last-bit gradient
            # difference in a leaf's near-zero entries would move the CPU's
            # next start by ~lr there, and its next gradients far more than
            # one step's rounding does
            p = tree_map(lambda t: t.detach().to(dev, copy=True), flag_params)
            state = opt.init(p)
            lg, lc, gg, gc = [], [], [], []
            for i in range(2):
                batch = clean_rows(p, pool[128 * i:128 * (i + 1)])
                to_cpu = lambda tree: tree_map(lambda t: t.to(cpu, copy=True), tree)  # noqa: E731
                on_cpu = (to_cpu(p), state._replace(mu=to_cpu(state.mu), nu=to_cpu(state.nu)))
                for where, start, losses, grads in ((dev, (p, state), lg, gg),
                                                    (cpu, on_cpu, lc, gc)):
                    opt_r = _Recorded(opt)
                    step = tr.make_train_step(acfg, opt_r, 1, torch.float32)
                    q, s, m = step(*start, batch.to(where)[None], None, 0.2)
                    losses.append(float(m["total_loss"]))
                    grads.append(opt_r.grads[0])
                    if start[0] is p:
                        p, state = q, s
        finally:
            rqvae.FUSED_TRAIN_MIN_CODEBOOK_VOLUME = default_volume
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
        leaf_rel = 0.0
        for step_g, step_c in zip(gg, gc):
            for (_, a), (_, b) in zip(step_g, step_c):
                err, scale = float((a - b).abs().max()), float(b.abs().max())
                check(err <= 1e-4 * scale + 1e-12, f"{route}: GPU vs CPU leaf {err} of {scale}")
                leaf_rel = max(leaf_rel, err / scale if scale else 0.0)
        check(loss_rel <= 1e-5, f"{route}: GPU vs CPU stage-1 loss differs by {loss_rel} relative")
        gpu_cpu[route] = dict(losses_gpu=lg, losses_cpu=lc, loss_rel_err=loss_rel,
                              worst_leaf_rel_err=leaf_rel)
    log(f"stage-1 fp32 steps, GPU vs CPU: {gpu_cpu}")

    # ---- phase 15: both kernels timed at both shapes, and the two routes ----
    with torch.no_grad():
        z_big = rqvae.encode(params, mcfg, corpus[:4096]).float().contiguous()
        train_at = {
            "flagship_64x3x256x32": _rq_timed(
                "rq_quantize_train", lambda: qk.rq_quantize_train(xf, cbf, "ROTATION_TRICK", 0.25),
                lambda: qk.rq_quantize_train_plain(xf, cbf), xf, cbf),
            "stretch_1024x4x2048x64": _rq_timed(
                "rq_quantize_train", lambda: qk.rq_quantize_train(xs, cbs, "ROTATION_TRICK", 0.25),
                lambda: qk.rq_quantize_train_plain(xs, cbs), xs, cbs)}
        tok_at = {"stretch_4096x4x2048x64": _rq_timed(
            "rq_tokenize", lambda: qk.rq_tokenize(z_big, cbs), lambda: qk.rq_tokenize_plain(z_big, cbs),
            z_big, cbs)}
    main_at = train_at["flagship_64x3x256x32"]
    stage1_kernels = [dict(
        name="rq_quantize_train", route="cuda", source="rqvae_tpu_torch/csrc/rq_quantize_train.cu",
        replaces="rqvae_tpu/ops/quantize_pallas.py:179",
        launches=flag_launches["rq_quantize_train"], max_abs_err=max(flag_err, train_err),
        ms=main_at["ms"], device_ms=main_at["device_ms"], plain_ms=main_at["plain_ms"],
        bound_ms=main_at["bound_ms"], bound_by=main_at["bound_by"], library_ms=None,
        at_shapes=train_at)]
    log(f"rq_quantize_train: {stage1_kernels[0]}; rq_tokenize at 4096x4x2048x64: {tok_at}")

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
        rq_quantize_train_stretch_launches=stretch_launches, rq_tokenize_at_shapes=tok_at)
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
    dead_cross = cross["k_mask"].clone()
    dead_cross[:2] = False
    # keys 16-31 masked (a dead middle tile of the forward) and every other
    # key valid with probability 1/2
    scatter = (torch.rand((b, n), device=dev, generator=gen) < 0.5) & (
        (torch.arange(n, device=dev) < 16) | (torch.arange(n, device=dev) >= 32))
    cases = [(kind, e["q"], e["k"], e["v"], unit_rms(e["g"]), e["k_mask"], e["causal"], None)
             for kind, e in rec.items()]
    cases += [("encoder_no_valid_key", enc["q"], enc["k"], enc["v"], unit_rms(enc["g"]), holes,
               False, slice(0, 2)),
              ("encoder_holes", enc["q"], enc["k"], enc["v"], unit_rms(enc["g"]), scatter, False,
               None),
              ("encoder_all_valid", enc["q"], enc["k"], enc["v"], unit_rms(enc["g"]), None, False,
               None),
              ("cross_no_valid_key", cross["q"], cross["k"], cross["v"], unit_rms(cross["g"]),
               dead_cross, False, slice(0, 2))]
    cases += [(f"decode_1x{t}", rand(b, h, 1, dh), rand(b, h, t, dh), rand(b, h, t, dh),
               rand(b, h, 1, dh), None, False, None) for t in (1, 2, 3, 4)]
    cases += [("beam_cross_32x81", rand(b, h, 32, dh), cross["k"], cross["v"], rand(b, h, 32, dh),
               cross["k_mask"], False, None),
              ("causal_48x48", rand(b, h, 48, dh), rand(b, h, 48, dh), rand(b, h, 48, dh),
               rand(b, h, 48, dh), ragged(b, 48), True, None),
              ("tall_208x96", rand(16, h, 208, dh), rand(16, h, 96, dh), rand(16, h, 96, dh),
               rand(16, h, 208, dh), ragged(16, 96), False, None),
              ("tall_255x16", rand(16, h, 255, dh), rand(16, h, 16, dh), rand(16, h, 16, dh),
               rand(16, h, 255, dh), ragged(16, 16), True, None),
              ("bucket_241", rand(16, h, 241, dh), rand(16, h, 241, dh), rand(16, h, 241, dh),
               rand(16, h, 241, dh), ragged(16, 241), False, None),
              ("causal_255_dh128", rand(4, h, 255, 128), rand(4, h, 255, 128), rand(4, h, 255, 128),
               rand(4, h, 255, 128), ragged(4, 255), True, None)]
    checks, errs = [], {"fwd": 0.0, "bwd": 0.0}
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        for case, q, k, v, g, km, causal, empty in cases:
            a = [t.to(dtype) for t in (q, k, v, g)]
            out, mm, inv = fa.flash_attention_small_fwd(*a[:3], k_mask=km, causal=causal)
            ref, ref_m, ref_inv = fa._plain_fwd(*a[:3], fa._key_masker(
                fa.mask_bias(km, q.shape[0], k.shape[2], dev), causal))
            # the backward reads the forward's m and inv
            got = fa.flash_attention_small_bwd(*a, mm, inv, k_mask=km, causal=causal)
            want = fa.flash_attention_small_bwd_plain(*a, k_mask=km, causal=causal)
            torch.cuda.synchronize()
            row = {"dtype": str(dtype)[6:], "case": case, "shape": list(q.shape),
                   "nk": k.shape[2], "causal": causal, "tol": tol}
            row.update(_hold_stats(f"small {case} {dtype}", dtype, mm, inv, ref_m, ref_inv))
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
                check(all(float(x[empty].abs().max()) == 0.0 for x in got),
                      f"small {case}: masked rows' gradients not zero")
            if dtype == torch.bfloat16 and case == "encoder_self":
                errs = {"fwd": row["out"], "bwd": max(row["dq"], row["dk"], row["dv"])}
            checks.append(row)
            log(f"small vs plain {row}")
    del out, ref, got, want, cases, scatter
    # the Python restatement of the bf16 backward's dispatch rule (the CPU
    # tests' emulation reads it) against the library's own, at every shape
    # the short route takes
    routes = {}
    for nq in range(1, fa.SMALL_MAX_LEN + 1):
        for nk in range(1, fa.SMALL_MAX_LEN + 1):
            got_route, want_route = fa.small_bwd_route(nq, nk), fa.small_bwd_kernel_route(nq, nk)
            if got_route != want_route:
                check(False, f"small_bwd_route({nq}, {nk}) = {got_route}, the library's {want_route}")
            routes[want_route] = routes.get(want_route, 0) + 1
    log(f"short backward routes over every (Nq, Nk) <= {fa.SMALL_MAX_LEN}: {routes}")

    # the forward's C gate: an output whose rows are not 16-byte aligned (a
    # view 4 bytes into its storage), handed to the library directly, must
    # take the CUDA-core kernel (the live kernel stores 16-byte rows) and
    # leave the context usable for the launches after it
    q, k, v = (enc[t][:16] for t in ("q", "k", "v"))
    b16, _, nq, _ = q.shape
    store = torch.empty(b16 * nq * h * dh + 2, dtype=torch.bfloat16, device=dev)
    o_off = store[2:].view(b16, nq, h, dh).transpose(1, 2)
    check(o_off.data_ptr() % 16 == 4, f"offset output at {o_off.data_ptr() % 16} bytes")
    km16 = enc["k_mask"][:16]
    m16 = torch.empty((b16, h, nq), dtype=torch.float32, device=dev)
    inv16 = torch.empty_like(m16)
    bias16 = fa.mask_bias(km16, b16, nq, dev)
    off_route = fa.small_fwd_kernel_route(q, k, v, o_off)
    check(off_route == "cuda_cores",
          f"short forward into an output 4 bytes off 16 gated to the {off_route} kernel")
    fa._launch(fa.flash_attention_small_fwd, fa._DTYPE_CODES[torch.bfloat16], q.data_ptr(),
               k.data_ptr(), v.data_ptr(), bias16.data_ptr(), o_off.data_ptr(), m16.data_ptr(),
               inv16.data_ptr(), fa._strides(q, k, v, o_off), b16, h, nq, nq, dh, 0,
               1.0 / math.sqrt(dh), fa._device_index(q), torch.cuda.current_stream(dev).cuda_stream)
    torch.cuda.synchronize()
    ref16 = fa.flash_attention_small_plain(q, k, v, k_mask=km16)
    off_err = float((o_off.float() - ref16.float()).abs().max())
    check(off_err <= 2e-2 and bool(torch.isfinite(o_off.float()).all()),
          f"short forward into an output 4 bytes off 16: {off_err} from the twin")
    after = fa.flash_attention_small_fwd(q, k, v, k_mask=km16)[0]
    torch.cuda.synchronize()
    after_route = fa.small_fwd_kernel_route(q, k, v, after)
    check(after_route == "live", f"the aligned launch after it gated to the {after_route} kernel")
    after_err = float((after.float() - ref16.float()).abs().max())
    check(after_err <= 2e-2, f"the launch after the offset output: {after_err} from the twin")
    checks.append({"case": "output_4_bytes_off_16", "shape": list(q.shape), "out": off_err,
                   "route": off_route, "launch_after": after_err, "route_after": after_route})
    log(f"short forward, output 4 bytes off 16: max |err| {off_err:.2e}; the next launch "
        f"{after_err:.2e}")
    del store, o_off, after, ref16

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
    # the serving path's short forward: the first call of each shape in one
    # beam search with the switch on (the encoder's 81 x 81, the beam-folded
    # cross 32 x 81, the decode steps' 1 x t), held against the twin and
    # timed on those operands
    serve_rec = {}

    def record_serve(q, k, v, *, k_mask=None, causal=False):
        key = f"{q.shape[2]}x{k.shape[2]}" + ("_causal" if causal else "")
        if key not in serve_rec:
            serve_rec[key] = dict(q=q, k=k, v=v, k_mask=k_mask, causal=causal)
        return real_small(q, k, v, k_mask=k_mask, causal=causal)

    os.environ[SHORT_FLASH_ENV] = "1"
    attn_ops.flash_attention_small = record_serve
    try:
        serve()
    finally:
        attn_ops.flash_attention_small = real_small
        os.environ.pop(SHORT_FLASH_ENV, None)
    serving_fwd = {}
    for key, e in serve_rec.items():
        sq, sk, sv, skm, sc = e["q"], e["k"], e["v"], e["k_mask"], e["causal"]
        got = fa.flash_attention_small_fwd(sq, sk, sv, k_mask=skm, causal=sc)[0].float()
        want = fa.flash_attention_small_plain(sq, sk, sv, k_mask=skm, causal=sc).float()
        err = float((got - want).abs().max())
        check(bool(torch.isfinite(got).all()) and torch.allclose(got, want, rtol=2e-2, atol=2e-2),
              f"serving short forward {key} differs from the plain twin by {err}")
        fn = lambda: fa.flash_attention_small_fwd(sq, sk, sv, k_mask=skm, causal=sc)  # noqa: E731
        serving_fwd[key] = dict(
            shape=list(sq.shape[:3]) + [sk.shape[2]], max_abs_err=err, ms=cuda_ms(fn, 50),
            device_ms=_device_ms(fn, 20, "small_fwd"),
            plain_ms=cuda_ms(lambda: fa.flash_attention_small_plain(sq, sk, sv, k_mask=skm,
                                                                    causal=sc), 10),
            **_short_bound(sq, sk, skm, sc, "fwd"))
    log(f"serving short forward by shape: {serving_fwd}")
    check({"81x81", "32x81"} <= set(serving_fwd),
          f"serving short forward shapes {sorted(serving_fwd)}")
    del p_ab, st_ab, gen_params, serve_rec, got, want

    # the short kernels at each step shape, on layer 0's recorded operands:
    # events, device time, the bound with every operand at its own length,
    # the twin and SDPA under the same mask (additive bias, causal cut)
    per_kind = model_cfg.n_layers // 2   # a step: 4 encoder self, 4 decoder self, 4 cross

    def time_shape(e):
        q, k, v, km, causal = e["q"], e["k"], e["v"], e["k_mask"], e["causal"]
        g = unit_rms(e["g"]).to(q.dtype)
        sb, sh, nq, sdh = q.shape
        nk = k.shape[2]
        _, mm, inv = fa.flash_attention_small_fwd(q, k, v, k_mask=km, causal=causal)
        fns = {"fwd": lambda: fa.flash_attention_small_fwd(q, k, v, k_mask=km, causal=causal),
               "bwd": lambda: fa.flash_attention_small_bwd(q, k, v, g, mm, inv, k_mask=km,
                                                           causal=causal)}
        plain = {"fwd": lambda: fa.flash_attention_small_plain(q, k, v, k_mask=km, causal=causal),
                 "bwd": lambda: fa.flash_attention_small_bwd_plain(q, k, v, g, k_mask=km,
                                                                   causal=causal)}
        mask = fa._key_masker(fa.mask_bias(km, sb, nk, dev), causal)(
            torch.zeros((sb, 1, nq, nk), device=dev)).to(q.dtype)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        lib_f = lambda: F.scaled_dot_product_attention(*leaves, attn_mask=mask)   # noqa: E731
        lib_fb = lambda: torch.autograd.backward(   # noqa: E731
            F.scaled_dot_product_attention(*leaves, attn_mask=mask), g)
        lib = {"fwd": cuda_ms(lib_f, 50), "fb": cuda_ms(lib_fb, 50)}
        lib_dev = {"fwd": _device_ms(lib_f, 20), "fb": _device_ms(lib_fb, 20)}
        out = dict(shape=[sb, sh, nq, nk, sdh], causal=causal, launches_per_step=per_kind)
        for d in ("fwd", "bwd"):
            bound = _short_bound(q, k, km, causal, d)
            out[d] = dict(ms=cuda_ms(fns[d], 50), device_ms=_device_ms(fns[d], 20, f"small_{d}"),
                          plain_ms=cuda_ms(plain[d], 20), **bound,
                          library_ms=lib["fwd"] if d == "fwd" else lib["fb"] - lib["fwd"],
                          library_device_ms=(lib_dev["fwd"] if d == "fwd"
                                             else lib_dev["fb"] - lib_dev["fwd"]))
        return out

    shapes = {kind: time_shape(rec[kind]) for kind in ("encoder_self", "decoder_self", "cross")}
    # the forward where nothing can be skipped: the encoder's operands, every key valid
    all_valid = dict(rec["encoder_self"], k_mask=None)
    def fn():
        return fa.flash_attention_small_fwd(all_valid["q"], all_valid["k"], all_valid["v"])

    fwd_all_valid = dict(ms=cuda_ms(fn, 50), device_ms=_device_ms(fn, 20, "small_fwd"),
                         **_short_bound(all_valid["q"], all_valid["k"], None, False, "fwd"))
    # the forward kernel's launch at each step shape: pairs a unit, stages,
    # warps, shared memory, CTAs an SM
    fwd_plans = {kind: fa.small_fwd_plan(e["q"].shape[0] * e["q"].shape[1], e["q"].shape[2],
                                         e["k"].shape[2], torch.cuda.current_device())
                 for kind, e in rec.items()}
    log(f"short forward, every key valid: {fwd_all_valid}; launch plans {fwd_plans}")
    per_step = {d: {key: sum(sh_[d][key] * sh_["launches_per_step"] for sh_ in shapes.values())
                    for key in ("ms", "device_ms", "bound_ms", "library_ms", "library_device_ms")}
                for d in ("fwd", "bwd")}
    log(f"short kernels by step shape: {shapes}; launch-weighted per step: {per_step}")

    # each kernel library raised its own kernels' opt-in once: every flash
    # library is loaded by now, and a further call raises nothing
    libs = (fa.flash_attention_fwd, fa.flash_attention_bwd, fa.flash_attention_spans_fwd,
            fa.flash_attention_spans_bwd, fa.flash_attention_small_fwd,
            fa.flash_attention_small_bwd)
    attribute_calls = {w.__name__: fa.attribute_calls(w) for w in libs}
    for e in rec.values():
        _, mm, inv = fa.flash_attention_small_fwd(e["q"], e["k"], e["v"], k_mask=e["k_mask"],
                                                  causal=e["causal"])
        fa.flash_attention_small_bwd(e["q"], e["k"], e["v"], unit_rms(e["g"]).to(e["q"].dtype), mm,
                                     inv, k_mask=e["k_mask"], causal=e["causal"])
    torch.cuda.synchronize()
    again = {w.__name__: fa.attribute_calls(w) for w in libs}
    check(all(n >= 1 for n in attribute_calls.values()),
          f"a kernel library never raised its kernels' opt-in: {attribute_calls}")
    check(again == attribute_calls, f"calls after the first raised an opt-in: {attribute_calls} -> "
          f"{again}")
    log(f"cudaFuncSetAttribute calls by library: {attribute_calls}")

    enc_t = shapes["encoder_self"]
    q, k, v, km = enc["q"], enc["k"], enc["v"], enc["k_mask"]
    g = unit_rms(enc["g"]).to(q.dtype)
    bnhd = [t.clone().requires_grad_(True).transpose(1, 2) for t in (q, k, v)]
    dense_mask = attn_ops.build_mask(n, n, k_mask=km)
    with torch.no_grad():
        dense_fwd = cuda_ms(lambda: attn_ops.sdpa(*bnhd, dense_mask), 50)
    dense_fwd_bwd = cuda_ms(lambda: torch.autograd.backward(
        attn_ops.sdpa(*bnhd, dense_mask), g.transpose(1, 2)), 50)
    del bnhd
    kernels = []
    for name, d, line in (("flash_attention_small_fwd", "fwd", 272),
                          ("flash_attention_small_bwd", "bwd", 296)):
        t = enc_t[d]
        kernels.append(dict(
            name=name, route="cuda", source=f"rqvae_tpu_torch/csrc/{name}.cu",
            replaces=f"rqvae_tpu/ops/flash_attention.py:{line}",
            launches=main_launches[name], max_abs_err=errs[d], ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"], device_ms=t["device_ms"],
            shapes={kind: {key: shapes[kind][d][key] for key in
                           ("ms", "device_ms", "bound_ms", "plain_ms", "library_ms",
                            "library_device_ms")} | {"launches_per_step": per_kind}
                    for kind in shapes},
            ms_per_step=per_step[d]["ms"], device_ms_per_step=per_step[d]["device_ms"]))
    log(f"short kernels at B={b}, H={h}, N={n}, Dh={dh} {q.dtype}: {kernels}; dense sdpa "
        f"{dense_fwd:.4f} / {dense_fwd_bwd - dense_fwd:.4f} ms")
    amazon.update(
        small_checks=checks, small_bwd_routes=routes,
        gpu_vs_cpu=dict(users=2, tokens=4 * N_HIST + 1, loss_rel_err=loss_rel,
                        worst_leaf_rel_err=leaf_rel),
        switch_ab=ab, train_profile=profile,   # one traced step, switch off and on
        attention_ms=dict(step_shapes=shapes, per_step=per_step,
                          dense_sdpa={"fwd": dense_fwd, "bwd": dense_fwd_bwd - dense_fwd},
                          fwd_all_valid=fwd_all_valid, fwd_plans=fwd_plans,
                          serving_fwd=serving_fwd),
        attribute_calls=attribute_calls)
    return amazon, kernels


def _write_beauty_raw(root: str, seed: int) -> int:
    """A raw Amazon Beauty split of the real one's shape (TIGER, Table 1):
    ``N_ITEMS`` items with metadata, ``AMAZON_USERS`` users with 5-core
    histories (at least 5 items, 8.88 on average: ~198,500 interactions),
    items drawn by a log-normal popularity; the three files
    ``amazon.process`` reads, under ``<root>/raw/beauty``. Returns the
    interaction count."""
    import gzip

    import numpy as np

    rng = np.random.RandomState(seed)
    raw = os.path.join(root, "raw", "beauty")
    os.makedirs(raw)
    lengths = 4 + rng.geometric(1.0 / (BEAUTY_ACTIONS_PER_USER - 4), AMAZON_USERS)
    pop = rng.lognormal(0.0, 1.0, N_ITEMS)
    flat = rng.choice(N_ITEMS, int(lengths.sum()), p=pop / pop.sum()) + 1   # 1-based ids
    ends = np.cumsum(lengths)
    with open(os.path.join(raw, "sequential_data.txt"), "w") as f:
        for user, (end, n) in enumerate(zip(ends, lengths), start=1):
            f.write(f"{user} {' '.join(map(str, flat[end - n:end]))}\n")
    asins = [f"B{i:09d}" for i in range(1, N_ITEMS + 1)]
    with open(os.path.join(raw, "datamaps.json"), "w") as f:
        json.dump({"item2id": {a: str(i) for i, a in enumerate(asins, start=1)}}, f)
    cats = ["Makeup", "Skin Care", "Hair Care", "Fragrance", "Tools & Accessories", "Bath & Body"]
    with gzip.open(os.path.join(raw, "meta.json.gz"), "wt") as f:
        for i, asin in enumerate(asins):
            meta = {"asin": asin, "title": f"Beauty product {i} {rng.randint(10**6)}",
                    "categories": [["Beauty", cats[i % len(cats)]]],
                    "price": round(float(rng.lognormal(2.5, 0.8)), 2)}
            if i % 7:
                meta["brand"] = f"brand {rng.randint(2000)}"
            f.write(repr(meta) + "\n")
    return int(lengths.sum())


ML_GENRES = ("Action", "Adventure", "Animation", "Children", "Comedy", "Crime", "Documentary",
             "Drama", "Fantasy", "Film-Noir", "Horror", "IMAX", "Musical", "Mystery", "Romance",
             "Sci-Fi", "Thriller", "War", "Western")


def _ml_titles_genres(rng, n: int, names=ML_GENRES, none_share: float = 0.01):
    """MovieLens-style titles ("Title (year)", a comma in some) and genre
    strings (1-4 of ``names`` joined by "|"; "(no genres listed)" in
    ``none_share`` of them, as ML-32M has and ML-1M has not)."""
    titles = [f"Movie {i}{', The' if i % 11 == 0 else ''} ({1900 + int(y)})"
              for i, y in enumerate(rng.randint(0, 124, n))]
    genres = []
    for k in rng.randint(1, 5, n):
        if rng.rand() < none_share:
            genres.append("(no genres listed)")
        else:
            pick = sorted(rng.choice(len(names), k, replace=False))
            genres.append("|".join(names[j] for j in pick))
    return titles, genres


def _ml_histories(rng, n_users: int, n_ratings: int, n_movies: int, *, distinct: bool):
    """Per-user rating counts (at least 20, as GroupLens requires; log-normal,
    scaled to ``n_ratings`` in all), movies by a Zipf-like popularity (each
    user's distinct when ``distinct``) and increasing timestamps. Returns
    (users, movie indices, ratings, timestamps), user-major."""
    import numpy as np

    raw = rng.lognormal(np.log(75.0), 1.1, n_users)
    lengths = 20 + np.floor(raw / raw.sum() * (n_ratings - 20 * n_users)).astype(np.int64)
    cap = n_movies * 3 // 5 if distinct else n_ratings   # ML-1M's longest user: 2,314 of 3,883
    lengths = np.minimum(lengths, cap)
    while int(lengths.sum()) < n_ratings:
        room = np.flatnonzero(lengths < cap)
        lengths[rng.choice(room, min(n_ratings - int(lengths.sum()), room.size),
                           replace=False)] += 1
    pop = 1.0 / np.arange(1, n_movies + 1) ** 0.9
    pop = pop[rng.permutation(n_movies)]
    pop /= pop.sum()
    if distinct:
        movies = np.concatenate([rng.choice(n_movies, n, replace=False, p=pop) for n in lengths])
    else:
        movies = rng.choice(n_movies, int(lengths.sum()), p=pop)
    users = np.repeat(np.arange(1, n_users + 1), lengths)
    start = np.repeat(rng.randint(789_652_009, 1_690_000_000, n_users), lengths)
    steps = rng.exponential(3600.0, int(lengths.sum())).astype(np.int64) + 1
    first = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    csum = np.cumsum(steps)
    ts = start + csum - np.repeat(csum[first] - steps[first], lengths)
    stars = rng.randint(1, 11, int(lengths.sum())) / 2.0
    return users, movies, stars, ts, lengths


def _write_ml32m_raw(root: str, seed: int, n_movies: int, n_users: int, n_ratings: int) -> dict:
    """A raw MovieLens 32M of the real one's shape under ``<root>/raw``:
    ``movies.csv`` (movieId,title,genres; sparse ids) and ``ratings.csv``
    (userId,movieId,rating,timestamp; half-star ratings, every user at least
    20, log-normal history lengths with a long tail, Zipf-like movie
    popularity). The full file holds 87,585 movies, 200,948 users and
    32,000,204 ratings; the caller passes the cut it runs at."""
    import numpy as np
    import pandas as pd

    rng = np.random.RandomState(seed)
    raw = os.path.join(root, "raw")
    os.makedirs(raw)
    ids = np.sort(rng.choice(np.arange(1, 292_758), n_movies, replace=False))
    titles, genres = _ml_titles_genres(rng, n_movies)
    pd.DataFrame({"movieId": ids, "title": titles, "genres": genres}).to_csv(
        os.path.join(raw, "movies.csv"), index=False)
    users, movies, stars, ts, lengths = _ml_histories(rng, n_users, n_ratings, n_movies,
                                                      distinct=False)
    pd.DataFrame({"userId": users, "movieId": ids[movies], "rating": stars,
                  "timestamp": ts}).to_csv(os.path.join(raw, "ratings.csv"), index=False)
    return dict(movies=n_movies, users=n_users, ratings=int(lengths.sum()),
                ratings_per_user_p50=float(np.median(lengths)),
                users_over_200=int((lengths > 200).sum()))


def _write_ml1m_raw(root: str, seed: int, n_movies: int = 3883, n_users: int = 6040,
                    n_ratings: int = 1_000_209) -> dict:
    """A raw MovieLens 1M of the real one's shape (3,883 movies, 6,040 users,
    1,000,209 ratings by default) under ``<root>/raw``: ``movies.dat``
    (MovieID::Title::Genres) and ``ratings.dat``
    (UserID::MovieID::Rating::Timestamp, whole stars), ISO-8859-1, every
    user at least 20 distinct movies."""
    import numpy as np

    rng = np.random.RandomState(seed)
    raw = os.path.join(root, "raw")
    os.makedirs(raw)
    titles, genres = _ml_titles_genres(rng, n_movies, [g for g in ML_GENRES if g != "IMAX"], 0.0)
    with open(os.path.join(raw, "movies.dat"), "w", encoding="ISO-8859-1") as f:
        f.writelines(f"{i}::{t}::{g}\n" for i, (t, g) in enumerate(zip(titles, genres), start=1))
    users, movies, stars, ts, lengths = _ml_histories(rng, n_users, n_ratings, n_movies,
                                                      distinct=True)
    stars = np.ceil(stars).astype(np.int64)
    with open(os.path.join(raw, "ratings.dat"), "w", encoding="ISO-8859-1") as f:
        f.writelines(f"{u}::{m + 1}::{r}::{t}\n" for u, m, r, t in zip(
            users.tolist(), movies.tolist(), stars.tolist(), ts.tolist()))
    return dict(movies=n_movies, users=n_users, ratings=int(lengths.sum()))


def _offline(dev, rq_ckpt, work) -> dict:
    """Phase 25: the offline path users run around training, at the Amazon
    Beauty width, with attend's default routes (the short switch unset):
    raw files -> ``amazon.process`` (the stub encoder) -> decoder
    ``train()`` over phase 11's RQ-VAE -> export and reload of both models
    (``models/io``) -> ``evaluate_checkpoint`` on the whole test split,
    counted. Returns the ``offline`` dict."""
    import numpy as np
    import torch

    from rqvae_tpu_torch.data import amazon, registry
    from rqvae_tpu_torch.data import dataset as dataset_lib
    from rqvae_tpu_torch.data.text import hashed_stub_encoder
    from rqvae_tpu_torch.evaluate import run_eval
    from rqvae_tpu_torch.models import generation, rqvae
    from rqvae_tpu_torch.models import io as model_io
    from rqvae_tpu_torch.ops.children_window import children_window, children_window_mask
    from rqvae_tpu_torch.ops.quantize_kernels import rq_tokenize
    from rqvae_tpu_torch.tokenizer import semids
    from rqvae_tpu_torch.train import checkpoint
    from rqvae_tpu_torch.train import train_decoder as td
    from rqvae_tpu_torch.utils import config as config_lib
    from rqvae_tpu_torch.utils.logging import MetricsLogger

    check(SHORT_FLASH_ENV not in os.environ, f"{SHORT_FLASH_ENV} is set for the offline path")
    metric_keys = lambda m: {k: v for k, v in m.items() if k.startswith(("h@", "ndcg"))}  # noqa: E731

    # ---- raw files -> artifacts ----
    root = os.path.join(work, "amazon")
    t0 = time.perf_counter()
    n_actions = _write_beauty_raw(root, SEED)
    fixture_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_dir = amazon.process(root, "beauty", encode_fn=hashed_stub_encoder())
    preprocess_s = time.perf_counter() - t0
    bundle = registry.load(registry.RecDataset.AMAZON, root, split="beauty")
    check(bundle.items.x.shape == (N_ITEMS, INPUT_DIM)
          and len(bundle.train_seqs) == len(bundle.test_seqs) == AMAZON_USERS,
          f"artifacts: items {bundle.items.x.shape}, test users {len(bundle.test_seqs)}")
    artifact_bytes = sum(os.path.getsize(os.path.join(out_dir, n)) for n in os.listdir(out_dir))
    log(f"offline: fixture {n_actions} interactions in {fixture_s:.2f} s, amazon.process "
        f"{preprocess_s:.2f} s, {artifact_bytes} artifact bytes")

    # ---- the decoder through train() on the artifacts ----
    class Capture(MetricsLogger):
        def __init__(self):
            super().__init__(every=1)
            self.records = []

        def log(self, step, metrics, force=False):
            self.records.append({"step": step, **{k: float(np.asarray(v))
                                                  for k, v in metrics.items()}})

    config = pathlib.Path(__file__).resolve().parent / "configs" / "decoder_amazon.json"
    cfg = config_lib.load_config(td.DecoderTrainConfig, str(config), [
        f"data_path={root}", f"pretrained_rqvae_path={rq_ckpt}",
        f"save_dir_root={work}/offline_decoder", f"iterations={OFFLINE_ITERS}", "amp=true",
        "log_every=50", f"partial_eval_every={OFFLINE_ITERS}", f"full_eval_every={OFFLINE_ITERS}",
        f"save_model_every={OFFLINE_ITERS}", f"eval_batches={AMAZON_EVAL_BATCHES}", f"seed={SEED}"])
    check(cfg.dataset == registry.RecDataset.AMAZON and cfg.vae_input_dim == INPUT_DIM,
          f"offline config {cfg}")
    cap = Capture()
    t0 = time.perf_counter()
    td.train(cfg, logger=cap, device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    losses = [r["total_loss"] for r in cap.records if "total_loss" in r]
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"offline decoder losses {losses}")
    check(checkpoint.latest_step(cfg.save_dir_root) == OFFLINE_ITERS - 1,
          f"offline decoder checkpoint {checkpoint.latest_step(cfg.save_dir_root)}")
    log(f"offline train(): {OFFLINE_ITERS} steps in {train_s:.1f} s, losses {losses}")

    # ---- export and reload both models ----
    model_cfg = cfg.retrieval_config(bundle.max_seq_len)
    vae_params, vae_cfg = td.load_frozen_rqvae(cfg, device=dev)
    dec_params = checkpoint.restore(cfg.save_dir_root, device=dev)[0]["params"]
    exports = {"rqvae": os.path.join(work, "export", "rqvae"),
               "decoder": os.path.join(work, "export", "decoder")}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model_io.save_pretrained(exports["rqvae"], vae_params, vae_cfg)
    model_io.save_pretrained(exports["decoder"], dec_params, model_cfg)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    vae2, vae_cfg2 = model_io.load_pretrained(exports["rqvae"], device=dev)
    dec2, model_cfg2 = model_io.load_pretrained(exports["decoder"], device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    check(vae_cfg2 == vae_cfg and model_cfg2 == model_cfg, "reloaded configs differ")
    corpus = torch.from_numpy(
        dataset_lib.features_for_model(bundle.items.x, vae_cfg.input_dim)).to(dev)
    index = semids.precompute_corpus_ids(vae_params, vae_cfg, corpus)
    check(torch.equal(index.cached_ids,
                      semids.precompute_corpus_ids(vae2, vae_cfg2, corpus).cached_ids),
          "the reloaded RQ-VAE gives other corpus IDs")
    raw = bundle.test_seqs.batch_at(np.arange(cfg.batch_size))
    tok = semids.tokenize_sequences(index, dataset_lib.to_device(
        dataset_lib.make_seq_batch(raw, bundle.items.x, with_features=False), dev))
    tok = tok._replace(sem_ids_fut=None, token_type_ids_fut=None)
    beams = [generation.generate_next_sem_ids(p, c, index, tok, k=cfg.generation_top_k,
                                              n_candidates=cfg.vae_codebook_size)
             for p, c in ((dec_params, model_cfg), (dec2, model_cfg2))]
    check(torch.equal(beams[0].sem_ids, beams[1].sem_ids)
          and torch.equal(beams[0].log_probas, beams[1].log_probas),
          "the reloaded decoder gives other beams")
    log(f"offline export: save {save_s:.3f} s, load {load_s:.3f} s; corpus IDs and "
        f"{cfg.batch_size} users' beams equal after the reload")
    del vae2, dec2, beams, dec_params

    # ---- the main path of this phase: the whole test split, counted ----
    rq_tokenize.launches = 0
    children_window_mask.launches = 0
    children_window.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = run_eval.evaluate_checkpoint(cfg, split="test", device=dev)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = {"rq_tokenize": rq_tokenize.launches,
                "children_window_mask": children_window_mask.launches,
                "children_window": children_window.launches}
    n_batches = math.ceil(AMAZON_USERS / cfg.batch_size)
    log(f"offline eval: {eval_s:.2f} s for {AMAZON_USERS} users, launches {launches}, {metrics}")
    check(launches == {"rq_tokenize": math.ceil(N_ITEMS / 4096),
                       "children_window_mask": 4 * n_batches, "children_window": 0},
          f"offline eval launches {launches}: expected rq_tokenize once a 4,096-row chunk, "
          f"the Mask epilogue 4 times in each of {n_batches} batches and Tokens never")
    check(metrics["split"] == "test" and metrics["n_users"] == AMAZON_USERS
          and metrics["checkpoint_step"] == OFFLINE_ITERS - 1, f"offline eval {metrics}")
    check(all(0.0 <= v <= 1.0 for v in metric_keys(metrics).values()),
          f"offline metrics out of [0, 1]: {metrics}")

    # ---- the kernels against their twins on this path's operands ----
    cbs = rqvae.effective_codebooks(vae_params, vae_cfg).float().contiguous()
    n_diff = n_ties = n_ties_d0 = 0
    rq_err = 0.0
    ids = []
    for i in range(0, N_ITEMS, 4096):
        z = rqvae.encode(vae_params, vae_cfg, corpus[i:i + 4096]).float().contiguous()
        k_out = rq_tokenize(z, cbs, commitment_weight=vae_cfg.commitment_weight)
        held = _hold_rq_tokenize(z, cbs, vae_cfg.commitment_weight, k_out)
        n_diff, n_ties, n_ties_d0 = n_diff + held[0], n_ties + held[1], n_ties_d0 + held[2]
        rq_err = max(rq_err, held[3])
        ids.append(k_out.sem_ids)
    check(torch.equal(torch.cat(ids).to(index.cached_ids.dtype), index.cached_ids[:, :-1]),
          "the corpus index's IDs are not rq_tokenize's")
    rq_check = dict(rows=N_ITEMS, id_rows_differ=n_diff, near_tie_rows_terms=n_ties,
                    near_tie_rows_d0=n_ties_d0, max_abs_err=rq_err,
                    max_duplicates=semids.max_duplicates(index), n_distinct=index.n_distinct)
    log(f"offline rq_tokenize vs plain on the stub corpus: {rq_check}")
    with _record_children_window(semids) as cw_calls:
        run_eval.evaluate_checkpoint(cfg, split="test", max_users=cfg.batch_size, device=dev)
    cw_rows = [int(a[1].shape[0]) for a in cw_calls]
    check(cw_rows == [1] + [cfg.batch_size * cfg.generation_top_k] * 3,
          f"children_window rows per level {cw_rows}")
    _hold_children_window(cw_calls, cfg.vae_codebook_size)
    log("offline children_window Tokens and Mask vs plain: identical at levels 0..3")
    tok_ms = wall_ms(lambda: semids.precompute_corpus_ids(vae_params, vae_cfg, corpus), 5)
    profile = _profile(lambda: run_eval.evaluate_checkpoint(
        cfg, split="test", max_users=cfg.batch_size, device=dev))
    del cw_calls, vae_params, corpus, index

    # ---- 64 users in fp32, exhaustive candidates: the card against the CPU ----
    small = dataclasses.replace(cfg, batch_size=OFFLINE_CPU_USERS,
                                generation_candidates=cfg.vae_codebook_size)
    m_gpu = run_eval.evaluate_checkpoint(small, split="test", max_users=OFFLINE_CPU_USERS,
                                         device=dev)
    m_cpu = run_eval.evaluate_checkpoint(small, split="test", max_users=OFFLINE_CPU_USERS,
                                         device="cpu")
    diff = max(abs(m_gpu[k] - m_cpu[k]) for k in metric_keys(m_cpu))
    log(f"offline {OFFLINE_CPU_USERS}-user fp32 eval: GPU {metric_keys(m_gpu)}, "
        f"CPU {metric_keys(m_cpu)}")
    check(set(m_gpu) == set(m_cpu) and diff <= 1e-6,
          f"offline GPU and CPU metrics differ by {diff}")

    train_evals = [r for r in cap.records if "ndcg@10" in r or "eval_loss" in r]
    return dict(
        fixture=dict(items=N_ITEMS, users=AMAZON_USERS, interactions=n_actions, write_s=fixture_s),
        preprocess_s=preprocess_s, artifact_bytes=artifact_bytes,
        train=dict(iterations=OFFLINE_ITERS, wall_s=train_s, losses=losses, evals=train_evals),
        export=dict(save_s=save_s, load_s=load_s, corpus_ids_equal=True,
                    beams_equal_users=cfg.batch_size),
        corpus_tokenize_ms=tok_ms, rq_tokenize_check=rq_check,
        eval=dict(split="test", users=AMAZON_USERS, batch=cfg.batch_size, batches=n_batches,
                  candidates=cfg.generation_candidates, beams=cfg.generation_top_k,
                  wall_s=eval_s, users_per_s=AMAZON_USERS / eval_s,
                  ms_per_batch=eval_s * 1e3 / n_batches, launches=launches,
                  metrics=metric_keys(metrics), profile_256_users=profile),
        children_window_check=dict(rows_per_level=cw_rows, identical=True),
        gpu_vs_cpu=dict(users=OFFLINE_CPU_USERS, dtype="float32", max_abs_diff=diff,
                        metrics=metric_keys(m_cpu)))


def _short_bound(q, k, k_mask, causal: bool, direction: str) -> dict:
    """The least time a short attention kernel (``fwd`` or ``bwd``) could take
    on these operands: the larger of its bytes over the memory rate and its
    products over the bf16 tensor-core rate. q, the output, g and the
    gradients count over every row; K and V reads only over the valid keys
    (a masked key weighs nothing: the kernels need its K and V for no row,
    and its dk and dv rows are written as zeros); the products (4 Dh a pair
    forward, 10 Dh backward) over the (query, key) pairs the mask allows."""
    import torch

    b, h, nq, dh = q.shape
    nk = k.shape[2]
    valid = torch.ones((b, nk), dtype=torch.bool, device=q.device) if k_mask is None else k_mask
    allowed = valid[:, None, :].expand(b, nq, nk)
    if causal:
        allowed = allowed & torch.ones((nq, nk), dtype=torch.bool, device=q.device).tril()
    pairs = h * int(allowed.sum())
    valid_keys = int(valid.sum())
    elt = q.element_size()
    kv_bytes = elt * 2 * h * dh * valid_keys
    stats = 4 * b * nk + 8 * b * h * nq   # key bias; m, inv
    rows = {"fwd": 2 * nq, "bwd": 3 * nq + 2 * nk}[direction]   # q, out / q, g, dq; dk, dv
    nbytes = elt * b * h * dh * rows + kv_bytes + stats
    flops = {"fwd": 4, "bwd": 10}[direction] * dh * pairs
    t_ops, t_bytes = flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return dict(bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops > t_bytes else "bytes", bytes=nbytes, flops=flops,
                valid_key_share=valid_keys / (b * nk), pair_share=int(allowed.sum()) / (b * nq * nk))


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


def _fp32_flash_bounds(kind, q, k, mask) -> dict:
    """The least time of the fp32 flat or span kernels' work on these
    operands, two ways: operations over the allowed (q, k) pairs (4 Dh
    forward, 10 Dh backward, the TPU cost estimate's count) at the fp32
    CUDA-core peak, and as three TF32 products at the TF32 tensor peak; each
    beside the bytes (q, out, g and the gradients for every row, K and V for
    the keys some row attends, the statistics and the mask) at the HBM rate."""
    import torch

    from rqvae_tpu_torch.ops import flash_attention as fa

    b, h, nq, dh = q.shape
    nk = k.shape[2]
    if kind == "flat":
        valid = (torch.ones((b, nk), dtype=torch.bool, device=q.device) if mask.get("k_mask") is None
                 else mask["k_mask"].reshape(b, nk))
        allowed = valid[:, None, :].expand(b, nq, nk)
        if mask.get("causal"):
            allowed = allowed & torch.ones((nq, nk), dtype=torch.bool, device=q.device).tril()
        mask_bytes = 4 * b * nk
    else:
        allowed = fa.span_mask((mask["lo"], mask["hi"], mask["extra"]), nk)
        mask_bytes = 12 * b * nq
    pairs = h * int(allowed.sum())
    kv_bytes = 4 * 2 * h * dh * int(allowed.any(dim=1).sum())
    row_bytes = 4 * b * h * nq * dh
    out = {"pairs": pairs, "dense_pairs": b * h * nq * nk}
    for d, ops, nbytes in (
            ("fwd", 4 * dh * pairs, 2 * row_bytes + kv_bytes + mask_bytes + 8 * b * h * nq),
            ("bwd", 10 * dh * pairs, 3 * row_bytes + 8 * b * h * nk * dh + kv_bytes + mask_bytes
             + 12 * b * h * nq)):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_simt, t_tf32 = ops / FP32_FLOP_PER_S * 1e3, 3 * ops / TF32_FLOP_PER_S * 1e3
        out[d] = dict(ops=ops, bytes=nbytes, bound_simt_ms=max(t_simt, t_bytes),
                      bound_simt_by="operations" if t_simt > t_bytes else "bytes",
                      bound_tf32x3_ms=max(t_tf32, t_bytes),
                      bound_tf32x3_by="operations" if t_tf32 > t_bytes else "bytes")
    return out


def _sdpa_backend(fn) -> dict:
    """The device kernels one call of ``fn`` runs, by device time, and the
    backend of ``F.scaled_dot_product_attention`` they name."""
    top = _profile(fn, top=4)["top_device_ops"]
    names = " ".join(t[0] for t in top).lower()
    backend = ("efficient" if "fmha" in names or "efficient" in names
               else "flash" if "flash" in names else "math" if top else "not traced")
    return dict(backend=backend, top_kernels=top)


def _fp32_flash_times(kind, q, k, v, g, *, sdpa: bool = True, **mask) -> dict:
    """The fp32 flat (``kind`` "flat": ``k_mask``, ``causal``) or span
    ("spans": ``lo``, ``hi``, ``extra``) kernels on these operands: each
    direction's route, CUDA-event ms, profiler device ms and the twin's ms;
    with ``sdpa``, ``F.scaled_dot_product_attention``'s fp32 ms with the mask
    as an additive bias and its backend; the bounds of
    ``_fp32_flash_bounds``."""
    import torch
    import torch.nn.functional as F

    from rqvae_tpu_torch.ops import flash_attention as fa

    if kind == "flat":
        km, causal = mask.get("k_mask"), bool(mask.get("causal", False))
        wrappers = (fa.flash_attention_fwd, fa.flash_attention_bwd)
        fwd = lambda: fa.flash_attention_fwd(q, k, v, k_mask=km, causal=causal)   # noqa: E731
        out, m, inv = fwd()
        bwd = lambda: fa.flash_attention_bwd(q, k, v, g, m, inv, k_mask=km, causal=causal)  # noqa: E731
        plain = (lambda: fa.flash_attention_plain(q, k, v, k_mask=km, causal=causal),
                 lambda: fa.flash_attention_bwd_plain(q, k, v, g, k_mask=km, causal=causal))
        bias = fa._key_masker(fa.mask_bias(km, q.shape[0], k.shape[2], q.device), causal)(
            torch.zeros((q.shape[0], 1, q.shape[2] if causal else 1, k.shape[2]), device=q.device))
    else:
        sp = (mask["lo"], mask["hi"], mask["extra"])
        wrappers = (fa.flash_attention_spans_fwd, fa.flash_attention_spans_bwd)
        fwd = lambda: fa.flash_attention_spans_fwd(q, k, v, *sp)   # noqa: E731
        out, m, inv = fwd()
        bwd = lambda: fa.flash_attention_spans_bwd(q, k, v, *sp, g, m, inv)   # noqa: E731
        plain = (lambda: fa.flash_attention_spans_plain(q, k, v, *sp),
                 lambda: fa.flash_attention_spans_bwd_plain(q, k, v, *sp, g))
        bias = torch.where(fa.span_mask(sp, k.shape[2])[:, None], 0.0, fa.NEG_INF).float()
    res = {"routes": {"fwd": fa.kernel_route(wrappers[0], q, k, v, out),
                      "bwd": fa.kernel_route(wrappers[1], q, k, v, g)}}
    for d, fn, tw in (("fwd", fwd, plain[0]), ("bwd", bwd, plain[1])):
        # a late profiler trace can drop device records (PERF.md §7): 0 is
        # recorded as not measured, and the CUDA events are the time
        res[d] = dict(ms=cuda_ms(fn, 10 if d == "fwd" else 5, warmup=2),
                      device_ms=_device_ms(fn, 3, "flash") or None,
                      plain_ms=cuda_ms(tw, 2, warmup=1),
                      kernels=[k for k in _profile(fn, top=6)["top_device_ops"] if "flash" in k[0]])
        torch.cuda.empty_cache()
    if sdpa:
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]

        def lib_fwd():
            return F.scaled_dot_product_attention(*leaves, attn_mask=bias)

        def lib_both():
            torch.autograd.backward(lib_fwd(), g)

        with torch.no_grad():
            res["fwd"]["sdpa_ms"] = cuda_ms(lib_fwd, 5, warmup=2)
            res["fwd"]["sdpa"] = _sdpa_backend(lib_fwd)
        both = cuda_ms(lib_both, 5, warmup=2)
        res["bwd"]["sdpa_ms"] = both - res["fwd"]["sdpa_ms"]
        res["bwd"]["sdpa_fwd_bwd_ms"] = both
        res["bwd"]["sdpa"] = _sdpa_backend(lib_both)
        del leaves
        torch.cuda.empty_cache()
    res["bounds"] = _fp32_flash_bounds(kind, q, k, mask)
    return res


@contextlib.contextmanager
def _record_children_window(semids, name: str = "children_window_mask"):
    """Record the operands of every call the beam search makes through
    ``semids.children_mask`` to ``semids.<name>`` (the real wrapper runs)."""
    real = getattr(semids, name)
    calls = []

    def record(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    setattr(semids, name, record)
    try:
        yield calls
    finally:
        setattr(semids, name, real)


def _hold_children_window(calls, k_tok: int) -> int:
    """Both epilogues against their twins on each recorded call's operands:
    bit-identical, or fail. Returns the largest token difference (0)."""
    import torch

    from rqvae_tpu_torch.ops import children_window as cw

    err = 0
    for args in calls:
        tokens = cw.children_window(*args, window=k_tok, k_tokens=k_tok)
        err = max(err, int((tokens - cw.children_window_plain(*args, window=k_tok,
                                                              k_tokens=k_tok)).abs().max()))
        mask = cw.children_window_mask(*args, window=k_tok, k_tokens=k_tok)
        check(torch.equal(mask, cw.children_window_mask_plain(*args, window=k_tok, k_tokens=k_tok)),
              f"children_window Mask differs from its twin at {args[1].shape[0]} rows")
    check(err == 0, f"children_window Tokens differs from its twin by {err}")
    return err


def _covered_keys(table, lo, cnt, window: int) -> int:
    """Keys the kernel reads: the union over rows of the slots
    [max(lo, 0), min(lo + min(cnt, window), n)) of the table."""
    import torch

    n = table.shape[0]
    start = lo.long().clamp(0, n)
    end = (lo.long() + cnt.long().clamp(max=window)).clamp(0, n)
    keep = end > start
    edges = torch.zeros(n + 1, dtype=torch.int64, device=table.device)
    edges.index_add_(0, start[keep], torch.ones_like(start[keep]))
    edges.index_add_(0, end[keep], -torch.ones_like(end[keep]))
    return int((edges.cumsum(0)[:n] > 0).sum())


def _cw_timed(calls, k_tok: int) -> dict:
    """Both epilogues' times on the recorded calls of a beam search's
    levels 1-3 (means over the levels, and each level's): profiler device
    time of the kernel over 20 launches, CUDA events over 100 back-to-back
    launches (the host's enqueue included), the plain twin's events and the
    bytes bound (lo / cnt / key0, the keys the rows' runs cover, the output
    once). For Mask, beside them, the route it replaces: the Tokens kernel
    then ``.long()``, ``zeros`` and ``scatter_`` on the same CUDA tensors
    (every device op of it)."""
    from rqvae_tpu_torch.ops import children_window as cw

    def fold(*args):
        return cw.fold_tokens(cw.children_window(*args, window=k_tok, k_tokens=k_tok), k_tok)

    def mean(fn):
        return sum(fn(args) for args in calls) / len(calls)

    rows = calls[0][1].shape[0]
    keys = [_covered_keys(a[0], a[1], a[2], k_tok) for a in calls]
    out = {}
    for name, wrapper, plain, out_bytes in (
            ("tokens", cw.children_window, cw.children_window_plain, 4 * rows * k_tok),
            ("mask", cw.children_window_mask, cw.children_window_mask_plain, rows * k_tok)):
        call = lambda args, f=wrapper: f(*args, window=k_tok, k_tokens=k_tok)  # noqa: E731
        twin = lambda args, f=plain: f(*args, window=k_tok, k_tokens=k_tok)  # noqa: E731
        by_level = [_device_ms_measured(lambda a=a: call(a), 20, "window_kernel") for a in calls]
        bytes_by_level = [8 * n_keys + 16 * rows + out_bytes for n_keys in keys]
        bound_by_level = [b / HBM_BYTES_PER_S * 1e3 for b in bytes_by_level]
        out[name] = dict(
            rows=rows, ms=mean(lambda a: cuda_ms(lambda: call(a), 100)),
            device_ms=sum(by_level) / len(by_level), device_ms_by_level=by_level,
            plain_ms=mean(lambda a: cuda_ms(lambda: twin(a), 20)),
            bound_ms=sum(bound_by_level) / len(calls), bound_ms_by_level=bound_by_level,
            bound_by="bytes", bound_bytes_by_level=bytes_by_level, covered_keys_by_level=keys,
            table_keys=calls[0][0].shape[0], library_ms=None)
    out["mask"]["fold_route_ms"] = mean(lambda a: cuda_ms(lambda: fold(*a), 100))
    out["mask"]["fold_route_device_ms"] = mean(lambda a: _device_ms_measured(lambda: fold(*a), 20))
    return out


def _hold_children_window_wide_k(dev) -> dict:
    """The Mask epilogue at codebook sizes past one word a lane (2,048, the
    stage-1 stretch's), past 48 KB of bitmaps (65,536: the kernel's shared
    memory opt-in) and at ``MASK_MAX_K``, against its twin on random
    operands: bit-identical, or fail. Returns {K: mask bits set}."""
    import numpy as np
    import torch

    from rqvae_tpu_torch.ops import children_window as cw

    rng = np.random.RandomState(SEED)
    set_bits = {}
    for k in (2048, 65536, cw.MASK_MAX_K):
        n, rows, window = 20_000, 96, 1024
        table = np.sort(rng.choice(max(4 * k, 4 * n), n, replace=False)).astype(np.int64)
        lo = rng.randint(0, n, rows).astype(np.int32)
        cnt = np.minimum(rng.randint(0, window + 64, rows), n - lo).astype(np.int32)
        key0 = table[lo] - rng.randint(-5, k, rows)   # children across [0, K) and past it
        args = [torch.from_numpy(a).to(dev) for a in (table, lo, cnt, key0.astype(np.int64))]
        got = cw.children_window_mask(*args, window=window, k_tokens=k)
        want = cw.children_window_mask_plain(*args, window=window, k_tokens=k)
        check(torch.equal(got, want), f"children_window Mask differs from its twin at K = {k}")
        set_bits[k] = int(want.sum())
        check(bool(want[:, : k // 2].any() and want[:, k // 2:].any()),
              f"children_window Mask at K = {k}: no child in one half of the bitmap")
    try:
        cw.children_window_mask(*args, window=window, k_tokens=cw.MASK_MAX_K + 1)
    except ValueError:
        pass
    else:
        check(False, "children_window_mask took k_tokens above MASK_MAX_K on CUDA")
    return set_bits


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


def _device_ms_measured(fn, iters: int, key: str = "") -> float:
    """``_device_ms``, traced again once if a trace held no device event of
    ``key`` (torch.profiler can drop a trace's device events); fails if the
    second reads none either."""
    ms = _device_ms(fn, iters, key)
    if ms <= 0:
        ms = _device_ms(fn, iters, key)
    check(ms > 0, f"no device event {key!r} in two traces")
    return ms


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


def _rq_bound(b, n_levels, k, d, train: bool):
    """The least time for one quantizer call: each input read once (x, the
    stack), each output written once ((L, B, D) twice for training, (B, D)
    twice for tokenizing; ids, loss), against 2 B L K D fp32 FMA flops.
    Returns (ms, "bytes" or "operations")."""
    out_floats = 2 * n_levels * b * d if train else 2 * b * d
    n_bytes = 4 * (b * d + n_levels * k * d + out_floats + b * n_levels + b)
    ops, mem = 2 * b * n_levels * k * d / FP32_FLOP_PER_S, n_bytes / HBM_BYTES_PER_S
    return max(ops, mem) * 1e3, "operations" if ops > mem else "bytes"


def _rq_timed(name, fn, plain, x, cbs) -> dict:
    """A quantizer kernel's times on (x, cbs): CUDA events over 50
    back-to-back calls (the host's enqueue included), profiler device time
    of its kernel over 20, the plain twin's events, the bound and the plan."""
    from rqvae_tpu_torch.ops import quantize_kernels as qk

    b, d = x.shape
    n_levels, k = cbs.shape[:2]
    bound, by = _rq_bound(b, n_levels, k, d, name == "rq_quantize_train")
    return dict(shape=[b, n_levels, k, d], ms=cuda_ms(fn, 50),
                device_ms=_device_ms(fn, 20, "rq::"), plain_ms=cuda_ms(plain, 20),
                bound_ms=bound, bound_by=by, plan=qk.kernel_plan(name, b, n_levels, k, d))


# ---- phases 26-28: the kernel switch, data parallelism, observability ----

def _launch_counters() -> dict:
    """Every kernel wrapper's launch counter, by name."""
    from rqvae_tpu_torch.ops import children_window as cw
    from rqvae_tpu_torch.ops import flash_attention as fa
    from rqvae_tpu_torch.ops import quantize_kernels as qk

    return {"rq_tokenize": qk.rq_tokenize, "rq_quantize_train": qk.rq_quantize_train,
            "children_window": cw.children_window,
            "children_window_mask": cw.children_window_mask,
            "flash_attention_fwd": fa.flash_attention_fwd,
            "flash_attention_bwd": fa.flash_attention_bwd,
            "flash_attention_spans_fwd": fa.flash_attention_spans_fwd,
            "flash_attention_spans_bwd": fa.flash_attention_spans_bwd,
            "flash_attention_small_fwd": fa.flash_attention_small_fwd,
            "flash_attention_small_bwd": fa.flash_attention_small_bwd}


def _counted(fn):
    """(fn(), every kernel's launches during it), counts zeroed just before."""
    import torch

    counters = _launch_counters()
    for c in counters.values():
        c.launches = 0
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, {name: c.launches for name, c in counters.items() if c.launches}


@contextlib.contextmanager
def _env(**values):
    """Set (a string) or unset (None) environment variables for the block."""
    saved = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _leaves_close(got, want, rel: float, what: str) -> float:
    """Every leaf of ``got`` within ``rel`` of the matching leaf's max-abs in
    ``want``; returns the worst ratio."""
    from rqvae_tpu_torch.utils.tree import tree_leaves

    worst = 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        err, scale = float((a.float().cpu() - b.float().cpu()).abs().max()), float(b.abs().max())
        check(err <= rel * scale + 1e-12, f"{what}: a leaf differs by {err} of {scale}")
        worst = max(worst, err / scale if scale else 0.0)
    return worst


class _Grads:
    """An optimizer that leaves the params alone and returns the gradients."""

    def update(self, params, state, grads):
        return grads


def _grads_close(got, want, rel: float, what: str) -> dict:
    """Gradient leaves of two runs ((path, tensor) lists) within ``rel`` of
    each leaf's max-abs, the scale floored at 1e-2 of the largest leaf's
    max-abs: a leaf whose gradients nearly cancel (max-abs ~1e-6 beside
    leaves of ~1e-3) sums terms of the tree's size, and its fp32 rounding
    follows them. Returns the worst ratio and its leaf."""
    top = max(float(b.abs().max()) for _, b in want)
    worst = {"rel_err": 0.0, "leaf": None}
    for (path, a), (_, b) in zip(got, want):
        err = float((a.float().cpu() - b.float().cpu()).abs().max())
        scale = max(float(b.abs().max()), 1e-2 * top)
        check(err <= rel * scale + 1e-12, f"{what}: leaf {path} differs by {err} of {scale} "
                                          f"(its max-abs {float(b.abs().max())})")
        if scale and err / scale > worst["rel_err"]:
            worst = {"rel_err": err / scale, "leaf": str(path)}
    return worst


class _Recorded:
    """An optimizer that applies ``opt`` and keeps a host copy of every
    gradient it is given (phases 31-33)."""

    def __init__(self, opt):
        self.opt, self.grads = opt, []

    def init(self, params):
        return self.opt.init(params)

    def update(self, params, state, grads):
        from rqvae_tpu_torch.utils.tree import tree_leaves_with_path

        self.grads.append([(p, g.detach().cpu().clone()) for p, g in tree_leaves_with_path(grads)])
        return self.opt.update(params, state, grads)


def _amazon_inputs(dev, rq_ckpt, work):
    """The flagship's RQ-VAE and the Amazon decoder's last checkpoint (phase
    20's), the 12,101-item corpus, 256 users' cropped 20-item histories and
    the flagship config's 64-row stage-1 batch, all from the seed."""
    import numpy as np
    import torch

    from rqvae_tpu_torch.data import dataset as dataset_lib
    from rqvae_tpu_torch.data.synthetic import synthetic_items, synthetic_sequences
    from rqvae_tpu_torch.train import checkpoint
    from rqvae_tpu_torch.train import train_decoder as td
    from rqvae_tpu_torch.train import train_rqvae as tr
    from rqvae_tpu_torch.utils import config as config_lib

    root = pathlib.Path(__file__).resolve().parent / "configs"
    dcfg = config_lib.load_config(td.DecoderTrainConfig, str(root / "decoder_amazon.json"), [
        "dataset=SYNTHETIC", f"vae_input_dim={INPUT_DIM}", f"pretrained_rqvae_path={rq_ckpt}"])
    rcfg = config_lib.load_config(tr.RqVaeTrainConfig, str(root / "rqvae_amazon.json"), [])
    rq_params = checkpoint.restore(rq_ckpt, device=dev)[0]["params"]
    dec_params = checkpoint.restore(f"{work}/decoder", device=dev)[0]["params"]
    items = synthetic_items(N_ITEMS, INPUT_DIM, seed=SEED)
    users, _ = synthetic_sequences(N_ITEMS, n_users=BATCH, seed=SEED + 7)
    batch = dataset_lib.make_seq_batch(users.sample_batch(np.random.default_rng(SEED + 7), BATCH,
                                                          subsample=True),
                                       items.x, with_features=False)
    x = torch.from_numpy(items.x[np.random.RandomState(SEED + 7).randint(0, N_ITEMS, 64)]).to(dev)
    return dict(dcfg=dcfg, model_cfg=dcfg.retrieval_config(N_HIST), rcfg=rcfg,
                vae_cfg=dcfg.vae_config(), rq_params=rq_params, dec_params=dec_params,
                corpus=torch.from_numpy(items.x).to(dev), batch=batch, x=x)


def _switch_ab(dev, rq_ckpt, work) -> dict:
    """Phase 26: ``RQVAE_TPU_DISABLE_PALLAS`` unset / set / set / unset over
    the Amazon beam search (256 users, the short route on), the Amazon flat
    step (the short route on), the flagship stage-1 step and corpus
    tokenization: with the variable set no kernel launches, and each path's
    result on the plain route is held against the kernel route's (fp32:
    beams and ids equal off near-ties, losses and leaves within PERF.md
    section 2's bounds); each path timed on both routes. Returns the
    ``dispatch`` dict."""
    import torch

    from rqvae_tpu_torch.data import dataset as dataset_lib
    from rqvae_tpu_torch.models import generation, rqvae
    from rqvae_tpu_torch.ops import dispatch
    from rqvae_tpu_torch.tokenizer import semids
    from rqvae_tpu_torch.train import optim
    from rqvae_tpu_torch.train import train_decoder as td
    from rqvae_tpu_torch.train import train_rqvae as tr
    from rqvae_tpu_torch.utils import amp
    from rqvae_tpu_torch.utils.tree import tree_map

    inp = _amazon_inputs(dev, rq_ckpt, work)
    model_cfg, vae_cfg, rcfg = inp["model_cfg"], inp["vae_cfg"], inp["rcfg"]
    acfg = rcfg.model_config()
    index = semids.precompute_corpus_ids(inp["rq_params"], vae_cfg, inp["corpus"])
    flat = dataset_lib.to_device(type(inp["batch"])(*(a[None] for a in inp["batch"])), dev)
    tok = semids.tokenize_sequences(index, dataset_lib.to_device(inp["batch"], dev))
    tok = tok._replace(sem_ids_fut=None, token_type_ids_fut=None)
    bf16_dec = amp.cast_floating(inp["dec_params"], torch.bfloat16)
    cfg0 = dataclasses.replace(model_cfg, dropout=0.0, input_dropout=0.0)
    opt = optim.adamw(3e-4, 0.035)
    dec_step = td.make_train_step(model_cfg, opt, index, 1, torch.bfloat16, 4)
    rq_step = tr.make_train_step(acfg, optim.adamw(rcfg.learning_rate, rcfg.weight_decay), 1,
                                 torch.float32)
    p_dec = tree_map(lambda t: t.detach().clone(), inp["dec_params"])
    s_dec = opt.init(p_dec)
    p_rq = tree_map(lambda t: t.detach().clone(), inp["rq_params"])
    s_rq = optim.adamw(rcfg.learning_rate, rcfg.weight_decay).init(p_rq)
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    x = inp["x"][None]

    paths = {
        "generate": lambda: generation.generate_next_sem_ids(bf16_dec, model_cfg, index, tok,
                                                             k=BEAMS, n_candidates=256),
        "decoder_step": lambda: dec_step(p_dec, s_dec, flat, gen),
        "stage1_step": lambda: rq_step(p_rq, s_rq, x, None, rcfg.gumbel_temperature),
        "corpus_tokenize": lambda: semids.precompute_corpus_ids(inp["rq_params"], vae_cfg,
                                                                inp["corpus"]),
    }
    iters = {"generate": 10, "decoder_step": 10, "stage1_step": 20, "corpus_tokenize": 10}
    times = {name: {"kernels": [], "plain": []} for name in paths}
    launches = {name: {} for name in paths}
    for route in ("kernels", "plain", "plain", "kernels"):
        with _env(RQVAE_TPU_DISABLE_PALLAS="1" if route == "plain" else None,
                  RQVAE_TPU_SHORT_FLASH="1"):
            check(dispatch.kernels_enabled() == (route == "kernels"), "the switch reads wrong")
            for name, fn in paths.items():
                for _ in range(3):
                    fn()
                _, launches[name][route] = _counted(fn)
                times[name][route].append(wall_ms(fn, iters[name]))
    for name in paths:
        check(launches[name]["plain"] == {},
              f"{name}: kernels launched with RQVAE_TPU_DISABLE_PALLAS=1: {launches[name]['plain']}")
    check(launches["generate"]["kernels"].get("flash_attention_small_fwd", 0) > 0
          and launches["generate"]["kernels"].get("children_window_mask") == 4,
          f"beam search launches on the kernel route {launches['generate']['kernels']}")
    check(launches["decoder_step"]["kernels"] == {"flash_attention_small_fwd": 12,
                                                  "flash_attention_small_bwd": 12},
          f"Amazon step launches on the kernel route {launches['decoder_step']['kernels']}")
    check(launches["stage1_step"]["kernels"] == {"rq_quantize_train": 1},
          f"stage-1 step launches on the kernel route {launches['stage1_step']['kernels']}")
    check(launches["corpus_tokenize"]["kernels"] == {"rq_tokenize": math.ceil(N_ITEMS / 4096)},
          f"tokenization launches on the kernel route {launches['corpus_tokenize']['kernels']}")

    # the results on both routes, fp32, from the same inputs
    held = {}
    runs = {}
    for route in ("kernels", "plain"):
        with _env(RQVAE_TPU_DISABLE_PALLAS="1" if route == "plain" else None,
                  RQVAE_TPU_SHORT_FLASH="1"):
            idx = semids.precompute_corpus_ids(inp["rq_params"], vae_cfg, inp["corpus"])
            out = generation.generate_next_sem_ids(inp["dec_params"], model_cfg, index, tok,
                                                   k=BEAMS, n_candidates=256)
            dl, _, dg = td.value_and_grad(td._make_microbatch_loss(cfg0, index, torch.float32),
                                          inp["dec_params"], type(flat)(*(t[0] for t in flat)),
                                          None)
            _, rg, rm = tr.make_train_step(acfg, _Grads(), 1, torch.float32)(
                inp["rq_params"], None, x, None, rcfg.gumbel_temperature)
            ids = rqvae.get_semantic_ids(inp["rq_params"], acfg, inp["x"], training=True).sem_ids
            runs[route] = dict(cached=idx.cached_ids, lp=out.log_probas, beams=out.sem_ids,
                               dec_loss=dl, dec_grads=dg, rq_loss=rm["total_loss"], rq_grads=rg,
                               ids=ids)
    k_run, p_run = runs["kernels"], runs["plain"]
    z = rqvae.encode(inp["rq_params"], vae_cfg, inp["corpus"]).float()
    cbs = rqvae.effective_codebooks(inp["rq_params"], vae_cfg).float()
    differ = (k_run["cached"][:, :-1] != p_run["cached"][:, :-1]).any(-1)
    near = _near_ties(z, cbs, p_run["cached"][:, :-1])
    check(not bool((differ & ~near).any()), "corpus ids differ off near-ties between the routes")
    held["corpus_ids_differ"], held["corpus_near_ties"] = int(differ.sum()), int(near.sum())
    lp_k, lp_p = k_run["lp"].float().cpu(), p_run["lp"].float().cpu()
    held["beam_logp_max_abs"] = float((lp_k - lp_p).abs().max())
    gap = torch.full_like(lp_p, float("inf"))
    gap[:, 1:] = lp_p[:, :-1] - lp_p[:, 1:]
    gap[:, :-1] = torch.minimum(gap[:, :-1], lp_p[:, :-1] - lp_p[:, 1:])
    clear = gap > 1e-3   # beams whose order cannot flip within the tolerance
    check(held["beam_logp_max_abs"] < 1e-3, f"beam log-probas differ: {held}")
    check(bool((k_run["beams"].cpu() == p_run["beams"].cpu()).all(-1)[clear].all()),
          "beams differ off near-ties between the routes")
    held["beams_compared"] = int(clear.sum())
    held["decoder_loss_rel"] = abs(float(k_run["dec_loss"]) - float(p_run["dec_loss"])) / abs(
        float(p_run["dec_loss"]))
    check(held["decoder_loss_rel"] <= 1e-4, f"Amazon fp32 loss between the routes: {held}")
    held["decoder_leaf_rel"] = _leaves_close(k_run["dec_grads"], p_run["dec_grads"], 1e-3,
                                             "Amazon fp32 step between the routes")
    xz = rqvae.encode(inp["rq_params"], acfg, inp["x"]).float()
    ids_differ = (k_run["ids"] != p_run["ids"]).any(-1)
    check(not bool((ids_differ & ~_near_ties(xz, rqvae.effective_codebooks(
        inp["rq_params"], acfg).float(), p_run["ids"])).any()),
        "stage-1 ids differ off near-ties between the routes")
    held["stage1_ids_differ"] = int(ids_differ.sum())
    if not bool(ids_differ.any()):
        # the decoder's bounds: the plain loop's rotation-trick forward scales
        # the codeword by |res| / (|res| + 1e-6), 1e-4 off at the flagship's
        # residual norms, where the fused kernel returns the codeword
        held["stage1_loss_rel"] = abs(float(k_run["rq_loss"]) - float(p_run["rq_loss"])) / abs(
            float(p_run["rq_loss"]))
        check(held["stage1_loss_rel"] <= 1e-4, f"stage-1 fp32 loss between the routes: {held}")
        held["stage1_leaf_rel"] = _leaves_close(k_run["rq_grads"], p_run["rq_grads"], 1e-3,
                                                "stage-1 fp32 step between the routes")
    means = {name: {r: sum(v) / len(v) for r, v in t.items()} for name, t in times.items()}
    result = dict(ms=times, mean_ms=means, launches=launches, held=held)
    log(f"phase 26, the kernel switch: {result}")
    return result


class _Records:
    """A metrics sink keeping every record with the host time it came."""

    def __init__(self):
        self.records = []

    def log(self, step, metrics, force=False):
        import numpy as np

        self.records.append({"step": step, "t": time.perf_counter(),
                             **{k: float(np.asarray(v)) for k, v in metrics.items()}})


def _step_ms(records) -> float:
    """Host ms a step between the second and the last training log."""
    logs = [r for r in records if "total_loss" in r]
    return (logs[-1]["t"] - logs[1]["t"]) * 1e3 / (logs[-1]["step"] - logs[1]["step"])


def _dp_configs(rq_ckpt, out, mesh_shape, **dec_kw):
    """Stage 1 (16 steps of the flagship config) and the Amazon decoder (20
    fp32 steps over ``rq_ckpt``) for phase 27, writing under ``out``."""
    from rqvae_tpu_torch.train import train_decoder as td
    from rqvae_tpu_torch.train import train_rqvae as tr
    from rqvae_tpu_torch.utils import config as config_lib

    root = pathlib.Path(__file__).resolve().parent / "configs"
    shape = [] if mesh_shape is None else [f"mesh_shape=[{mesh_shape[0]},{mesh_shape[1]}]"]
    rcfg = config_lib.load_config(tr.RqVaeTrainConfig, str(root / "rqvae_amazon.json"), [
        "dataset=SYNTHETIC", f"synthetic_n_items={N_ITEMS}", f"seed={SEED}", "iterations=16",
        "steps_per_call=8", "log_every=4", "eval_every=16", "save_model_every=16",
        f"save_dir_root={out}/rq"] + shape)
    dcfg = config_lib.load_config(td.DecoderTrainConfig, str(root / "decoder_amazon.json"), [
        "dataset=SYNTHETIC", f"synthetic_n_items={N_ITEMS}", f"synthetic_n_users={AMAZON_USERS}",
        f"vae_input_dim={INPUT_DIM}", f"seed={SEED}", f"pretrained_rqvae_path={rq_ckpt}",
        f"save_dir_root={out}/decoder", f"batch_size={BATCH}", "iterations=20", "log_every=5",
        "amp=false",
        "partial_eval_every=20", "full_eval_every=20", "save_model_every=20",
        "eval_batches=2"] + shape + [f"{k}={v}" for k, v in dec_kw.items()])
    return rcfg, dcfg


def _dp_worker(kind: str, work: str, device: str, rq_ckpt: str) -> int:
    """A rank of phase 27 on ``device``, started by ``_dp_launch`` with
    torchrun's variables: ``world1`` (one rank, NCCL on the card) or
    ``world2`` (two ranks sharing the one card over gloo); the decoders read
    the flagship's RQ-VAE at ``rq_ckpt``. Writes ``<work>/<kind>_r<rank>.json``."""
    import torch

    from rqvae_tpu_torch.evaluate import run_eval
    from rqvae_tpu_torch.parallel import mesh
    from rqvae_tpu_torch.train import train_decoder as td
    from rqvae_tpu_torch.train import train_rqvae as tr

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ[SHORT_FLASH_ENV] = "1"
    if kind == "profile":   # one process, no group: the trace as users take it
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
            os.environ.pop(k)
        res, rank = _profiled_run(work, rq_ckpt, torch.device(device)), 0
    elif kind == "world1":
        # the same calls without a group, then in a group of one (NCCL)
        torchrun = {k: os.environ.pop(k) for k in
                    ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
        res = {}
        for label in ("no_group", "group"):
            if label == "group":
                os.environ.update(torchrun)
            out = f"{work}/world1_{label}"
            rcfg, dcfg = _dp_configs(rq_ckpt, out, (1, 1))
            mesh.collective_calls = 0
            logs = {}
            for name, fn, cfg in (("rq", tr.train, rcfg), ("decoder", td.train, dcfg)):
                rec = _Records()
                fn(cfg, logger=rec, device=device)
                logs[name] = rec.records
            # both evals read the group-less run's checkpoint: the same weights
            ev = run_eval.evaluate_checkpoint(
                dataclasses.replace(dcfg, generation_candidates=256),
                checkpoint=f"{work}/world1_no_group/decoder", split="eval", max_users=512,
                device=device)
            res[label] = dict(logs=logs, eval=ev, collectives=mesh.collective_calls,
                              world=mesh.world_size(),
                              backend=(torch.distributed.get_backend()
                                       if torch.distributed.is_initialized() else None),
                              rq_step_ms=_step_ms(logs["rq"]),
                              decoder_step_ms=_step_ms(logs["decoder"]))
        rank = 0
    else:
        from rqvae_tpu_torch.data.schemas import SeqBatch
        from rqvae_tpu_torch.tokenizer import semids
        from rqvae_tpu_torch.train import optim
        from rqvae_tpu_torch.utils import amp

        dev = torch.device(device)   # both ranks on the one card
        inp = torch.load(f"{work}/dp_inputs.pt", map_location=dev, weights_only=False)
        res = {"world": mesh.maybe_init_distributed(dev, backend="gloo")}
        res["backend"] = torch.distributed.get_backend()
        mesh.make_mesh((2, 1))
        rank = mesh.rank()
        index = semids.build_index(inp["cached"], inp["k"])
        half = inp["x"].shape[1] // 2
        rows = BATCH // 2
        batch = SeqBatch(*(t[:, rank * rows:(rank + 1) * rows] for t in inp["batch"]))
        x = inp["x"][:, rank * half:(rank + 1) * half]
        dec_loss, dec_grads, rq_loss, rq_grads, launches = _dp_steps(
            inp["model_cfg"], inp["acfg"], index, inp["dec_params"], inp["rq_params"], batch, x,
            inp["gumbel_t"])
        res.update(dec_loss=dec_loss, rq_loss=rq_loss, launches=launches)
        torch.save({"dec_grads": dec_grads, "rq_grads": rq_grads},
                   f"{work}/world2_grads_r{rank}.pt")
        # the two-rank steps' times: bf16 decoder and fp32 stage 1, real AdamW
        opt = optim.adamw(3e-4, 0.035)
        p = amp.cast_floating(inp["dec_params"], torch.float32)
        st = opt.init(p)
        step = td.make_train_step(inp["model_cfg"], opt, index, 1, torch.bfloat16, 4)
        gen = torch.Generator(device=dev).manual_seed(SEED + rank)
        res["decoder_step_ms"] = _wall_ms_on(dev, lambda: step(p, st, batch, gen), 10)
        ropt = optim.adamw(1e-4, 0.01)
        rp = dict(inp["rq_params"])
        rst = ropt.init(rp)
        rstep = tr.make_train_step(inp["acfg"], ropt, 1, torch.float32)
        res["rq_step_ms"] = _wall_ms_on(dev, lambda: rstep(rp, rst, x, None, inp["gumbel_t"]), 20)
    with open(f"{work}/{kind}_r{rank}.json", "w") as f:
        json.dump(res, f)
    return 0


def _profiled_run(work: str, rq_ckpt: str, dev) -> dict:
    """Phase 28's profiled call: the Amazon ``train_decoder.train`` (8 steps,
    the short route on) with a ``StepProfiler`` window of steps 3-5, its
    trace read back; then the back-to-back session probe."""
    from rqvae_tpu_torch.train import train_decoder as td

    trace_dir = f"{work}/trace"
    _, dcfg = _dp_configs(rq_ckpt, f"{work}/profiled", None, amp="true", iterations=8,
                          profile_dir=trace_dir, profile_start=3, profile_steps=3,
                          eval_batches=1)
    td.train(dcfg, logger=_Records(), device=dev)
    files = sorted(pathlib.Path(trace_dir).glob("*.pt.trace.json"))
    events = json.loads(files[0].read_text())["traceEvents"] if files else []
    kernels = [e for e in events if e.get("cat") == "kernel"]
    short = [e["name"] for e in kernels if "small::" in e.get("name", "")]
    return dict(files=[f.name for f in files], bytes=sum(f.stat().st_size for f in files),
                kernel_events=len(kernels), short_kernel_events=len(short),
                short_kernel_names=sorted({n[:60] for n in short}),
                kernel_busy_ms=sum(e.get("dur", 0) for e in kernels) / 1e3,
                steps=dcfg.profile_steps, probe=_trace_probe(dev))


def _wall_ms_on(dev, fn, iters: int) -> float:
    """``wall_ms`` on ``dev`` (synchronised when it is the card)."""
    if dev.type == "cuda":
        return wall_ms(fn, iters)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def _dp_steps(model_cfg, acfg, index, dec_params, rq_params, batch, x, gumbel_t):
    """Phase 27 (b)'s fp32 steps (the Amazon flat step, dropout 0, and the
    flagship stage-1 step): (decoder loss, grads, stage-1 loss, grads,
    launches), reduced over the data replicas when a mesh is registered."""
    import torch

    from rqvae_tpu_torch.train import train_decoder as td
    from rqvae_tpu_torch.train import train_rqvae as tr
    from rqvae_tpu_torch.utils.tree import tree_map

    cfg0 = dataclasses.replace(model_cfg, dropout=0.0, input_dropout=0.0)
    with _env(RQVAE_TPU_SHORT_FLASH="1"):
        (_, dg, dm), dl = _counted(lambda: td.make_train_step(
            cfg0, _Grads(), index, 1, torch.float32, 4)(dec_params, None, batch, None))
        (_, rg, rm), rl = _counted(lambda: tr.make_train_step(acfg, _Grads(), 1, torch.float32)(
            rq_params, None, x, None, gumbel_t))
    dm = td._replicated(dm, "mean")
    rm = tr._replicated({"total_loss": rm["total_loss"]}, "mean")
    cpu = lambda tree: tree_map(lambda t: t.detach().cpu(), tree)  # noqa: E731
    return float(dm["total_loss"]), cpu(dg), float(rm["total_loss"]), cpu(rg), {**dl, **rl}


def _dp_launch(kind: str, work: str, world: int, device, rq_ckpt: str,
               timeout: int = 420, flag: str = "--dp-worker", extra: dict = None) -> list:
    """Start ``world`` ranks of this script (``flag kind``: phase 27's
    ``--dp-worker``, phases 29 and 30's ``--tp-worker``) on ``device`` with
    torchrun's variables and a free port (``extra`` joins the sizes they
    read); wait, stop them all, and return each rank's result."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, str(pathlib.Path(__file__).resolve()), flag, kind, work,
         str(device), json.dumps({"N_ITEMS": N_ITEMS, "AMAZON_USERS": AMAZON_USERS,
                                  "BATCH": BATCH, "ML_ITEMS": ML_ITEMS, "ML_HIST": ML_HIST,
                                  "TP_ML_BATCH": TP_ML_BATCH,
                                  "TP_AMAZON_BATCH": TP_AMAZON_BATCH,
                                  "TP_AMAZON_ITERS": TP_AMAZON_ITERS,
                                  "TP_RQ_ITERS": TP_RQ_ITERS, "TP4_ITERS": TP4_ITERS,
                                  "ML_DEC_EXTRA": list(ML_DEC_EXTRA),
                                  **(extra or {})}), rq_ckpt],
        env=dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                 MASTER_ADDR="localhost", MASTER_PORT=str(port)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            log(out[-6000:])
        check(p.returncode == 0, f"{flag} {kind} rank {r} exited {p.returncode}")
    return [json.load(open(f"{work}/{kind}_r{r}.json")) for r in range(world)]


def _distributed(dev, rq_ckpt, work) -> dict:
    """Phase 27: (a) one rank in an NCCL group of one runs stage 1 (16
    steps), the Amazon decoder (20 fp32 steps over the flagship's RQ-VAE)
    and ``run_eval`` with
    ``mesh_shape=(1, 1)``; their losses and metrics equal the same calls
    without a group within PERF.md section 2's bounds, with no collective;
    (b) two ranks sharing the one card over gloo run the Amazon flat step and
    the flagship stage-1 step, fp32, on a global batch split in two; each
    equals one process over the whole batch (loss 1e-4 relative, leaves 1e-3
    of max-abs), each rank's kernels launched. Returns the ``distributed``
    dict."""
    import torch

    from rqvae_tpu_torch.tokenizer import semids

    # ---- (a) NCCL, world size 1 ----
    w1 = _dp_launch("world1", work, 1, dev, rq_ckpt)[0]
    a, b = w1["no_group"], w1["group"]
    nccl = "nccl" if dev.type == "cuda" else "gloo"
    check(a["world"] == b["world"] == 1 and a["backend"] is None and b["backend"] == nccl,
          f"world-1 run: {a['world']} / {b['world']}, backends {a['backend']} / {b['backend']}")
    check(a["collectives"] == b["collectives"] == 0,
          f"collectives at world size 1: {a['collectives']} / {b['collectives']}")
    worst = {}
    for stage, bound in (("rq", 1e-5), ("decoder", 1e-4)):
        ra = [r for r in a["logs"][stage] if "total_loss" in r or "eval_total_loss" in r
              or "eval_loss" in r]
        rb = [r for r in b["logs"][stage] if "total_loss" in r or "eval_total_loss" in r
              or "eval_loss" in r]
        check([r["step"] for r in ra] == [r["step"] for r in rb], f"{stage} log steps differ")
        worst[stage] = 0.0
        for x, y in zip(ra, rb):
            for key in ("total_loss", "eval_total_loss", "eval_loss"):
                if key in x:
                    rel = abs(x[key] - y[key]) / abs(x[key])
                    worst[stage] = max(worst[stage], rel)
                    check(rel <= bound, f"{stage} {key} at step {x['step']}: {x[key]} vs {y[key]}")
    for key, v in a["eval"].items():
        if isinstance(v, float):
            check(v == b["eval"][key], f"eval {key}: {v} without a group, {b['eval'][key]} in one")
    world1 = dict(loss_rel_worst=worst, eval=b["eval"], collectives=b["collectives"],
                  rq_step_ms={"no_group": a["rq_step_ms"], "group": b["rq_step_ms"]},
                  decoder_step_ms={"no_group": a["decoder_step_ms"],
                                   "group": b["decoder_step_ms"]})
    log(f"phase 27 (a), one rank in an NCCL group: {world1}")

    # ---- (b) two ranks on the one card, gloo over CUDA tensors ----
    inp = _amazon_inputs(dev, rq_ckpt, work)
    index = semids.precompute_corpus_ids(inp["rq_params"], inp["vae_cfg"], inp["corpus"])
    from rqvae_tpu_torch.data import dataset as dataset_lib

    flat = dataset_lib.to_device(type(inp["batch"])(*(a_[None] for a_ in inp["batch"])), dev)
    acfg = inp["rcfg"].model_config()
    cpu = lambda t: t.detach().cpu()  # noqa: E731
    from rqvae_tpu_torch.utils.tree import tree_map

    torch.save(dict(cached=cpu(index.cached_ids), k=index.codebook_size,
                    batch=type(flat)(*(cpu(t) for t in flat)), x=cpu(inp["x"][None]),
                    dec_params=tree_map(cpu, inp["dec_params"]),
                    rq_params=tree_map(cpu, inp["rq_params"]), model_cfg=inp["model_cfg"],
                    acfg=acfg, gumbel_t=inp["rcfg"].gumbel_temperature),
               f"{work}/dp_inputs.pt")
    ranks = _dp_launch("world2", work, 2, dev, rq_ckpt)
    want = _dp_steps(inp["model_cfg"], acfg, index, inp["dec_params"], inp["rq_params"], flat,
                     inp["x"][None], inp["rcfg"].gumbel_temperature)
    world2 = dict(ranks=[], one_process={"decoder_loss": want[0], "rq_loss": want[2],
                                         "launches": want[4]})
    for r, res in enumerate(ranks):
        check(res["world"] == 2 and res["backend"] == "gloo", f"rank {r}: {res}")
        grads = torch.load(f"{work}/world2_grads_r{r}.pt", weights_only=False)
        dec_rel = abs(res["dec_loss"] - want[0]) / abs(want[0])
        rq_rel = abs(res["rq_loss"] - want[2]) / abs(want[2])
        check(dec_rel <= 1e-4 and rq_rel <= 1e-4, f"rank {r} losses: {dec_rel}, {rq_rel}")
        leaf = {"decoder": _leaves_close(grads["dec_grads"], want[1], 1e-3, f"rank {r} decoder"),
                "rq": _leaves_close(grads["rq_grads"], want[3], 1e-3, f"rank {r} stage 1")}
        check(res["launches"].get("flash_attention_small_fwd") == 12
              and res["launches"].get("flash_attention_small_bwd") == 12
              and res["launches"].get("rq_quantize_train") == 1,
              f"rank {r} launches {res['launches']}")
        world2["ranks"].append(dict(decoder_loss_rel=dec_rel, rq_loss_rel=rq_rel,
                                    leaf_rel=leaf, launches=res["launches"],
                                    decoder_step_ms=res["decoder_step_ms"],
                                    rq_step_ms=res["rq_step_ms"]))
    result = {"world1_nccl": world1, "world2_gloo_one_card": world2}
    log(f"phase 27 (b), two ranks over gloo on one card: {world2}")
    return result


def _trace_probe(dev) -> dict:
    """Twenty torch.profiler sessions in a row over 5 short-forward launches
    each, alternately with and without a device synchronise before the
    session stops: the CUDA events each session holds (the same in every
    session, were the sessions kept apart)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rqvae_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v = (torch.randn(BATCH, 8, 81, 64, device=dev, generator=g).to(torch.bfloat16)
               for _ in range(3))
    mask = torch.ones(BATCH, 81, dtype=torch.bool, device=dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    events = {"sync": [], "no_sync": [], "sync_kernel": [], "no_sync_kernel": []}
    for i in range(20):
        mode = "sync" if i % 2 == 0 else "no_sync"
        sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fa.flash_attention_small_fwd(q, k, v, k_mask=mask, causal=False)
            if mode == "sync":
                sync()
        device = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        events[mode].append(sum(e.count for e in device))
        events[f"{mode}_kernel"].append(sum(e.count for e in device if "small::" in e.key))
        sync()
    return events


def _observability(dev, rq_ckpt, work) -> dict:
    """Phase 28: a ``StepProfiler`` window of 3 steps inside the Amazon
    ``train_decoder.train`` call, in a process of its own as users run it
    (the trace file exists and holds CUDA kernel events, the short kernels'
    among them), a probe of back-to-back profiler sessions in that process
    and in this one (recorded, not held: torch.profiler's multi-session
    behaviour, not the port's), a finite ``debug_nans=True`` run and its cost a step,
    and the native batcher built from source, its crop invariants and
    ``batch_at`` at batch 256 against the Python path. Returns the
    ``observability`` dict."""
    import numpy as np
    import torch

    from rqvae_tpu_torch import native
    from rqvae_tpu_torch.data.synthetic import synthetic_sequences
    from rqvae_tpu_torch.train import train_decoder as td

    out = {}
    # ---- the profiler window, through the entry point, in a fresh process ----
    prof = _dp_launch("profile", work, 1, dev, rq_ckpt)[0]
    check(len(prof["files"]) == 1, f"profiler trace files: {prof['files']}")
    check(prof["kernel_events"] > 0, "the profiler window holds no CUDA kernel event")
    short = prof["short_kernel_names"]
    check(any("fwd" in n for n in short) and any("bwd" in n for n in short),
          f"the short kernels are not in the trace: {short[:4]}")
    out["profiler"] = prof
    # the same probe here, after phases 1-27's profiler sessions: recorded
    out["profiler_sessions_probe"] = {"fresh_process": prof.pop("probe"),
                                      "after_phases_1_27": _trace_probe(dev)}

    # ---- debug_nans: a finite run passes; its cost a step ----
    steps = {}
    for flag in ("false", "true"):
        _, dcfg = _dp_configs(rq_ckpt, f"{work}/nans_{flag}", None, amp="true", iterations=15,
                              debug_nans=flag, eval_batches=1)
        with _env(RQVAE_TPU_SHORT_FLASH="1"):
            rec = _Records()
            td.train(dcfg, logger=rec, device=dev)
        losses = [r["total_loss"] for r in rec.records if "total_loss" in r]
        check(all(math.isfinite(x) for x in losses), f"debug_nans={flag}: losses {losses}")
        steps[flag] = _step_ms(rec.records)
    out["debug_nans"] = dict(step_ms_off=steps["false"], step_ms_on=steps["true"],
                             cost_ms_per_step=steps["true"] - steps["false"])

    # ---- the native batcher: built here from the checkout's source ----
    saved_dir = native.BUILD_DIR
    native.BUILD_DIR = pathlib.Path(work) / "native"   # empty: a build from source
    native._load.cache_clear()
    try:
        t0 = time.perf_counter()
        native._load()
        build_s = time.perf_counter() - t0
    finally:
        native.BUILD_DIR = saved_dir
    users, _ = synthetic_sequences(N_ITEMS, n_users=AMAZON_USERS, seed=SEED + 9)
    idx = np.random.default_rng(SEED).integers(0, len(users), BATCH)
    ids, fut = native.subsample_batch(users.item_ids, users.item_ids_fut, idx, users.max_seq_len,
                                      SEED)
    for b, i in enumerate(idx):
        row = users.item_ids[i]
        seq = row[row >= 0].tolist() + [int(users.item_ids_fut[i, 0])]
        crop = ids[b][ids[b] >= 0].tolist() + [int(fut[b])]
        check(min(3, len(seq)) <= len(crop) <= users.max_seq_len + 1
              and any(seq[s:s + len(crop)] == crop for s in range(len(seq) - len(crop) + 1)),
              f"native crop {b} is not a window of its row")
    times = {"native": [], "python": []}
    for mode in ("native", "python", "python", "native"):
        with _env(RQVAE_TPU_DISABLE_NATIVE="1" if mode == "python" else None):
            rng = np.random.default_rng(SEED)
            t0 = time.perf_counter()
            for _ in range(50):
                users.batch_at(idx, rng)
            times[mode].append((time.perf_counter() - t0) * 1e3 / 50)
    out["native_batcher"] = dict(build_s=build_s, batch=BATCH, crops_held=len(idx),
                                 batch_at_ms=times,
                                 batch_at_mean_ms={k: sum(v) / len(v) for k, v in times.items()})
    log(f"phase 28, observability: {out}")
    return out


TP_ML_BATCH = 32        # phase 29 (a): gloo stages each activation all_reduce through the host
TP_AMAZON_BATCH = 64    # phase 29 (b): the Amazon train() batch under two ranks on one card
TP_AMAZON_ITERS = 20
TP_RQ_ITERS = 16


def _tp_ml32m_inputs(dev):
    """Phase 29 (a)'s inputs: the ML-32M decoder of ``configs/decoder_ml32m.json``
    (width 384, 6 heads, 4 + 4 layers, embedding 128, MLP 1024, dropout 0)
    with random weights from the seed, the ML_ITEMS-item index and a batch
    of TP_ML_BATCH cropped 200-item histories (801 encoder tokens)."""
    import numpy as np
    import torch

    from rqvae_tpu_torch.models import retrieval
    from rqvae_tpu_torch.train import train_decoder as td
    from rqvae_tpu_torch.utils import config as config_lib

    root = pathlib.Path(__file__).resolve().parent / "configs"
    dcfg = config_lib.load_config(td.DecoderTrainConfig, str(root / "decoder_ml32m.json"),
                                  ["dropout_p=0.0"])
    cfg = dataclasses.replace(dcfg.retrieval_config(ML_HIST), input_dropout=0.0)
    rng = np.random.RandomState(SEED)
    index = _ml32m_index(rng, dev)
    ids = rng.randint(0, ML_ITEMS, (TP_ML_BATCH, ML_HIST)).astype(np.int32)
    lengths = _crop_lengths(rng, TP_ML_BATCH, ML_HIST)
    ids = np.where(np.arange(ML_HIST)[None, :] < lengths[:, None], ids, -1)
    ids_fut = rng.randint(0, ML_ITEMS, (TP_ML_BATCH, 1)).astype(np.int32)
    flat = _seq_batch(ids, ids_fut, np.arange(TP_ML_BATCH, dtype=np.int32), dev)
    flat = type(flat)(*(t[None] for t in flat))
    params = retrieval.init(torch.Generator().manual_seed(SEED), cfg, device=dev)
    return cfg, index, flat, params


def _tp_ml32m_step(cfg, index, flat, params, dtype, dev):
    """One ML-32M flat step (gradients captured, no update): (loss, grads,
    launches, collectives by kind, data collectives)."""
    from rqvae_tpu_torch.parallel import mesh
    from rqvae_tpu_torch.parallel import tensor as ttp
    from rqvae_tpu_torch.train import train_decoder as td

    step = td.make_train_step(cfg, _Grads(), index, 1, dtype, 4)
    ttp.calls.clear()
    mesh.collective_calls = 0
    (_, grads, m), launches = _counted(lambda: step(params, None, flat, None))
    calls, data_calls = dict(ttp.calls), mesh.collective_calls
    ms = _wall_ms_on(dev, lambda: step(params, None, flat, None), 3)
    return float(m["total_loss"]), grads, launches, calls, data_calls, ms


def _tp_flash_twins(cfg, index, flat, params, dtype) -> dict:
    """The flat flash kernels against their twins on this rank's own layer-0
    encoder operands (its H / m heads), recorded in a rerun of the step;
    forward and backward errors over the reference's max-abs."""
    import torch

    from rqvae_tpu_torch.ops import attention as attn_ops
    from rqvae_tpu_torch.ops import flash_attention as fa
    from rqvae_tpu_torch.train import train_decoder as td

    seen = []
    real = attn_ops.flash_attention

    def record(q, k, v, **kw):
        if not seen:
            seen.append((q.detach(), k.detach(), v.detach(), kw))
        return real(q, k, v, **kw)

    real_plain = attn_ops.flash_attention_plain   # the route a CPU rehearsal takes

    def record_plain(q, k, v, **kw):
        if not seen:
            seen.append((q.detach(), k.detach(), v.detach(), kw))
        return real_plain(q, k, v, **kw)

    attn_ops.flash_attention, attn_ops.flash_attention_plain = record, record_plain
    try:
        td.make_train_step(cfg, _Grads(), index, 1, dtype, 4)(params, None, flat, None)
    finally:
        attn_ops.flash_attention, attn_ops.flash_attention_plain = real, real_plain
    q, k, v, kw = seen[0]
    g = torch.randn(q.shape, generator=torch.Generator(device=q.device).manual_seed(SEED),
                    device=q.device).to(q.dtype)
    errs = {}
    outs = []
    for fn in (fa.flash_attention, fa.flash_attention_plain):
        qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
        out = fn(qq, kk, vv, **kw)
        outs.append([out.detach()] + [t.detach() for t in
                                      torch.autograd.grad(out, (qq, kk, vv), g)])
    for name, a, b in zip(("out", "dq", "dk", "dv"), *outs):
        errs[name] = float((a.float() - b.float()).abs().max()) / max(
            float(b.float().abs().max()), 1e-12)
    return dict(heads=int(q.shape[1]), shape=list(q.shape), rel_err=errs)


def _tp_configs(rq_ckpt, out, mesh_shape, tensor_parallel: bool):
    """Phase 29's stage-1 (TP_RQ_ITERS flagship steps) and Amazon decoder
    (TP_AMAZON_ITERS bf16 steps at batch TP_AMAZON_BATCH, then the eval:
    one batch of beam search) configs on ``mesh_shape``."""
    rcfg, dcfg = _dp_configs(rq_ckpt, out, mesh_shape, amp="true",
                             batch_size=TP_AMAZON_BATCH, iterations=TP_AMAZON_ITERS,
                             partial_eval_every=TP_AMAZON_ITERS, full_eval_every=TP_AMAZON_ITERS,
                             save_model_every=TP_AMAZON_ITERS, eval_batches=1)
    rcfg = dataclasses.replace(rcfg, iterations=TP_RQ_ITERS, eval_every=TP_RQ_ITERS,
                               save_model_every=TP_RQ_ITERS, tensor_parallel=tensor_parallel)
    return rcfg, dataclasses.replace(dcfg, tensor_parallel=tensor_parallel)


def _tp_loops(rq_ckpt, out, mesh_shape, tensor_parallel: bool, dev) -> dict:
    """Stage 1 then the Amazon decoder through ``train()`` (the short route
    on), each counted: (records, launches, host ms a step)."""
    from rqvae_tpu_torch.parallel import mesh
    from rqvae_tpu_torch.parallel import tensor as ttp
    from rqvae_tpu_torch.train import train_decoder as td
    from rqvae_tpu_torch.train import train_rqvae as tr

    rcfg, dcfg = _tp_configs(rq_ckpt, out, mesh_shape, tensor_parallel)
    res = {}
    with _env(RQVAE_TPU_SHORT_FLASH="1"):
        for name, fn, cfg in (("rq", tr.train, rcfg), ("decoder", td.train, dcfg)):
            rec = _Records()
            ttp.calls.clear()
            mesh.collective_calls = 0
            params, launches = _counted(lambda: fn(cfg, logger=rec, device=dev))
            spec = mesh.rqvae_tp_spec if name == "rq" else mesh.retrieval_tp_spec
            heads = None if name == "rq" else cfg.attn_heads
            whole = mesh.fetch_to_host(params, spec, heads)   # a collective under TP
            res[name] = dict(records=rec.records, launches=launches, step_ms=_step_ms(rec.records),
                             collectives={**ttp.calls, "data": mesh.collective_calls},
                             params=whole)
    return res


def _tp_worker(kind: str, work: str, device: str, rq_ckpt: str) -> int:
    """A rank of phase 29 (``tp``: two ranks sharing the one card over gloo,
    mesh (1, 2), tensor_parallel) or phase 30 (``tp4``: four ranks, mesh
    (1, 4), where ML-32M's 6 heads stay whole on every rank): (a) the ML-32M
    flat step in fp32 and bf16 on the shards, its flash kernels against
    their twins on the rank's heads; then phase 29's stage 1 and Amazon
    decoder through ``train()`` (b, c), or phase 30's
    ``configs/decoder_ml32m.json`` through ``train()`` on the ML-32M
    artifacts at ``ML_DATA`` over the RQ-VAE at ``rq_ckpt`` (b). Writes
    ``<work>/<kind>_r<rank>.json`` and ``<work>/<kind>_r<rank>.pt``."""
    import torch

    from rqvae_tpu_torch.parallel import mesh
    from rqvae_tpu_torch.parallel import tensor as ttp
    from rqvae_tpu_torch.utils.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    res = {"world": mesh.maybe_init_distributed(dev, backend="gloo")}
    res["backend"] = torch.distributed.get_backend()
    tp_mesh = mesh.make_mesh((1, 4) if kind == "tp4" else (1, 2), tensor_parallel=True)
    rank = mesh.rank()
    res["mesh"] = dict(data=tp_mesh.data, model=tp_mesh.model, tp=ttp.size(),
                       model_index=ttp.index())
    cfg, index, flat, params = _tp_ml32m_inputs(dev)
    shards = mesh.shard_params(params, mesh.retrieval_tp_spec, cfg.num_heads)
    saved = {}
    res["ml32m"] = {}
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        loss, grads, launches, calls, data_calls, ms = _tp_ml32m_step(cfg, index, flat, shards,
                                                                      dtype, dev)
        saved[name] = tree_map(lambda t: t.detach().cpu(),
                               mesh.gather_params(grads, mesh.retrieval_tp_spec,
                                                  cfg.num_heads))
        res["ml32m"][name] = dict(loss=loss, launches=launches, collectives=calls,
                                  data_collectives=data_calls, step_ms=ms,
                                  twins=_tp_flash_twins(cfg, index, flat, shards, dtype))
    del shards, params
    if kind == "tp4":
        res["train"], saved["decoder_params"] = _tp4_train(rq_ckpt, work, dev)
    else:
        loops = _tp_loops(rq_ckpt, f"{work}/tp_loops", (1, 2), True, dev)
        for name, entry in loops.items():
            saved[f"{name}_params"] = entry.pop("params")
        res["loops"] = loops
    torch.save(saved, f"{work}/{kind}_r{rank}.pt")
    with open(f"{work}/{kind}_r{rank}.json", "w") as f:
        json.dump(res, f)
    return 0


def _tensor_parallel(dev, rq_ckpt, work, smi: str) -> dict:
    """Phase 29: two ranks share the one card over gloo at mesh (1, 2) with
    ``tensor_parallel``: (a) the ML-32M flat step at full width (batch cut to
    TP_ML_BATCH) in fp32 and bf16 against one process on the card (fp32
    loss 1e-4 relative, gathered leaves 1e-3 of max-abs; bf16 loss 2e-2
    relative, leaves as ``_bf16_leaves_close`` says), 4 flash forward and 4 backward launches a rank a step on
    3 of 6 heads, each kernel against its twin on the rank's own operands;
    (b) the Amazon decoder through ``train()`` (short kernels on 4 of 8
    heads, ``children_window_mask`` in the beam search); (c) the flagship
    stage 1 through ``train()``: no ``rq_quantize_train``, ``rq_tokenize`` in
    rank 0's diversity metrics; (d) both TP checkpoints restore into one
    process with the ranks' gathered leaves, bit for bit."""
    import torch

    from rqvae_tpu_torch.train import checkpoint
    from rqvae_tpu_torch.utils.tree import tree_leaves

    # one process on the card first, so its times are its own
    cfg, one = _tp_one_process(dev)
    one_loops = _tp_loops(rq_ckpt, f"{work}/one_loops", None, False, dev)
    torch.cuda.empty_cache()

    ranks = _dp_launch("tp", work, 2, dev, rq_ckpt, flag="--tp-worker")
    out = dict(card=smi, mesh=[1, 2], ranks=[], one_process={})
    for name in ("fp32", "bf16"):
        out["one_process"][f"ml32m_{name}"] = dict(loss=one[name]["loss"],
                                                   step_ms=one[name]["step_ms"],
                                                   launches=one[name]["launches"])
    for name in ("rq", "decoder"):
        out["one_process"][name] = dict(step_ms=one_loops[name]["step_ms"],
                                        launches=one_loops[name]["launches"])
    for r, res in enumerate(ranks):
        entry = dict(ml32m=_hold_tp_ml32m("phase 29", r, res, f"{work}/tp_r{r}.pt", one,
                                          cfg.num_heads // 2, 2), loops={})
        rq, dec = res["loops"]["rq"], res["loops"]["decoder"]
        check("rq_quantize_train" not in rq["launches"],
              f"phase 29 rank {r}: rq_quantize_train under TP {rq['launches']}")
        check(r != 0 or rq["launches"].get("rq_tokenize", 0) > 0,
              f"phase 29 rank 0: no rq_tokenize in the diversity metrics {rq['launches']}")
        check(dec["launches"].get("flash_attention_small_fwd", 0) > 0
              and dec["launches"].get("flash_attention_small_bwd", 0) > 0
              and dec["launches"].get("children_window_mask", 0) > 0,
              f"phase 29 rank {r} Amazon launches {dec['launches']}")
        for name, recs in (("rq", rq["records"]), ("decoder", dec["records"])):
            losses = [x["total_loss"] for x in recs if "total_loss" in x]
            check(len(losses) >= 2 and all(math.isfinite(x) for x in losses),
                  f"phase 29 rank {r} {name} losses {losses}")
        evals = {k: v for x in dec["records"] for k, v in x.items()
                 if k.startswith(("h@", "ndcg"))}
        check(evals and all(0.0 <= v <= 1.0 for v in evals.values()),
              f"phase 29 rank {r} eval {evals}")
        for name in ("rq", "decoder"):
            entry["loops"][name] = dict(step_ms=res["loops"][name]["step_ms"],
                                        launches=res["loops"][name]["launches"],
                                        collectives=res["loops"][name]["collectives"])
        entry["loops"]["decoder"]["eval"] = evals
        out["ranks"].append(entry)

    # (d) the TP checkpoints restore into one process, equal to the ranks' leaves
    saved = torch.load(f"{work}/tp_r0.pt", weights_only=False)
    for name in ("rq", "decoder"):
        state, _ = checkpoint.restore(f"{work}/tp_loops/{name}", device="cpu")
        for a, b in zip(tree_leaves(state["params"]), tree_leaves(saved[f"{name}_params"])):
            check(torch.equal(a, b), f"phase 29 {name} checkpoint leaf differs")
    out["checkpoints_restore_whole"] = True
    log(f"phase 29, tensor parallel: {out}")
    return out


# ---- phases 30-33: the shipped MovieLens configs through the entry points ----

ML32_USERS = 20_096        # a tenth of ML-32M's 200,948 users ...
ML32_RATINGS = 3_200_020   # ... and of its 32,000,204 ratings
ML_RQ_ITERS = 300          # phase 31's steps a config (the configs: 50,000)
ML_DEC_ITERS = 100         # phase 32's steps before the resume (decoder_ml32m.json: 20,000)
ML_DEC_RESUME_ITERS = 20
TP4_ITERS = 10             # phase 30 (b)
ML_DATA = None             # phase 30's ranks: the ML-32M artifacts' root
ML_DEC_EXTRA = ()          # overrides after the decoder config's (a CPU rehearsal cuts it)
ML_PACK_ROWS = 16          # phase 33 (a): packed rows a step (the config packs none)
ML_BRANCH_ITERS = 10       # phase 33's steps a branch
ML_CPU_USERS = 2           # phase 32's fp32 steps held against the CPU
ML1M_DEC_ITERS = 30        # phase 34's steps (decoder_ml1m.json: 100,000)


def _flat_span_wrappers() -> dict:
    """The flat and span wrappers, whose launches are also counted by route."""
    from rqvae_tpu_torch.ops import flash_attention as fa

    return {w.__name__: w for w in (fa.flash_attention_fwd, fa.flash_attention_bwd,
                                    fa.flash_attention_spans_fwd, fa.flash_attention_spans_bwd)}


def _zero_routes() -> None:
    for w in _flat_span_wrappers().values():
        w.route_launches = dict.fromkeys(w.route_launches, 0)


def _routes_used() -> dict:
    """Each flat / span wrapper's launches by route since ``_zero_routes``
    (the routes it took)."""
    return {name: {r: n for r, n in w.route_launches.items() if n}
            for name, w in _flat_span_wrappers().items() if w.launches}


@contextlib.contextmanager
def _flash_recorder(min_len: int):
    """Record the first differentiable ``attend`` flat flash call whose keys
    number ``min_len`` or more (encoder layer 0 of the first such step): q,
    k, v, the key mask and, once the backward has run, its upstream g."""
    from rqvae_tpu_torch.ops import attention as attn_ops

    rec, real = {}, attn_ops.flash_attention

    def record(q, k, v, *, k_mask=None, causal=False):
        out = real(q, k, v, k_mask=k_mask, causal=causal)
        if not rec and q.requires_grad and k.shape[2] >= min_len:
            rec.update(q=q.detach(), k=k.detach(), v=v.detach(), k_mask=k_mask, causal=causal)
            out.register_hook(lambda g: rec.__setitem__("g", g.detach()))
        return out

    attn_ops.flash_attention = record
    try:
        yield rec
    finally:
        attn_ops.flash_attention = real


def _fp32_held(kind, q, k, v, g, **mask) -> dict:
    """The flat or span wrappers' out, dq, dk, dv against the twins'
    (``_fp32_flash_times``' arguments): {name: (max |err|, within 1e-4)}."""
    import torch

    from rqvae_tpu_torch.ops import flash_attention as fa

    if kind == "flat":
        out, m, inv = fa.flash_attention_fwd(q, k, v, **mask)
        got = (out,) + fa.flash_attention_bwd(q, k, v, g, m, inv, **mask)
        want = (fa.flash_attention_plain(q, k, v, **mask),) + fa.flash_attention_bwd_plain(
            q, k, v, g, **mask)
    else:
        sp = (mask["lo"], mask["hi"], mask["extra"])
        out, m, inv = fa.flash_attention_spans_fwd(q, k, v, *sp)
        got = (out,) + fa.flash_attention_spans_bwd(q, k, v, *sp, g, m, inv)
        want = (fa.flash_attention_spans_plain(q, k, v, *sp),) + \
            fa.flash_attention_spans_bwd_plain(q, k, v, *sp, g)
    held = {name: (float((x - y).abs().max()), bool(torch.allclose(x, y, rtol=1e-4, atol=1e-4)))
            for name, x, y in zip(("out", "dq", "dk", "dv"), got, want)}
    del got, want, out
    torch.cuda.empty_cache()
    return held


def _fp32_row(kind, q, k, v, g, per_step: int, **mask) -> dict:
    """The fp32 kernels on a phase's own operands (the upstream gradient
    scaled to unit RMS), held against the twins (1e-4) and timed
    (``_fp32_flash_times``), with the phase's launches a step: an
    ``at_shapes`` entry's ``fp32`` key."""
    import torch

    from rqvae_tpu_torch.ops import flash_attention as fa

    check(q.dtype == torch.float32, f"fp32 row on {q.dtype} operands")
    g = g / g.pow(2).mean().sqrt()   # the loss's upstream gradient at unit RMS, as in phase 7
    held = _fp32_held(kind, q, k, v, g, **mask)
    errs = {name: err for name, (err, _) in held.items()}
    for name, (err, ok) in held.items():
        check(ok, f"fp32 {kind} kernels {name} differ from the twin by {err}")
    res = _fp32_flash_times(kind, q, k, v, g, **mask)
    check(res["routes"] == {"fwd": "tf32x3", "bwd": "tf32x3"}, f"fp32 routes {res['routes']}")
    return dict(shape=list(q.shape), max_abs_err=errs, launches_per_step=per_step, **res)


def _ml_config(cls, name: str, overrides) -> object:
    from rqvae_tpu_torch.utils import config as config_lib

    path = pathlib.Path(__file__).resolve().parent / "configs" / f"{name}.json"
    return config_lib.load_config(cls, str(path), list(overrides))


def _movielens_data(work: str) -> tuple:
    """The raw ML-32M (cut to ML32_USERS users and ML32_RATINGS ratings; the
    84,432 movies its ratings reach, ML_ITEMS) and ML-1M (whole) fixtures,
    written from the seed and run through the port's ``movielens.process``
    with the stub encoder. Returns (ml32m root, ml1m root, what it made)."""
    from rqvae_tpu_torch.data import movielens, registry
    from rqvae_tpu_torch.data.text import hashed_stub_encoder

    out = {}
    roots = {}
    for name, write in (("ml32m", lambda r: _write_ml32m_raw(r, SEED, ML_ITEMS, ML32_USERS,
                                                             ML32_RATINGS)),
                        ("ml1m", lambda r: _write_ml1m_raw(r, SEED))):
        root = roots[name] = f"{work}/{name}"
        t0 = time.perf_counter()
        raw = write(root)
        fixture_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        movielens.process(root, name, encode_fn=hashed_stub_encoder())
        process_s = time.perf_counter() - t0
        bundle = registry.load(registry.RecDataset.ML_32M if name == "ml32m"
                               else registry.RecDataset.ML_1M, root)
        train_len = (bundle.train_seqs.item_ids >= 0).sum(axis=1)
        out[name] = dict(raw=raw, fixture_s=fixture_s, process_s=process_s,
                         items=list(bundle.items.x.shape), train_rows=len(bundle.train_seqs),
                         eval_rows=len(bundle.eval_seqs),
                         train_rows_at_200=int((train_len == 200).sum()))
    check(out["ml32m"]["items"][0] == ML_ITEMS, f"ML-32M artifacts: {out['ml32m']}")
    check(out["ml32m"]["train_rows_at_200"] > 0, "no full 200-item ML-32M windows")
    log(f"phases 30-33 data: {out}")
    return roots["ml32m"], roots["ml1m"], out


def _ml_stage1(dev, work: str, roots: dict) -> tuple:
    """Phase 31: ``configs/rqvae_ml32m.json`` (rotation trick, embed 64) on
    the ML-32M fixture's items and ``configs/rqvae_ml1m.json``
    (Gumbel-softmax, embed 32) on the ML-1M one's, each through
    ``train_rqvae.train`` (ML_RQ_ITERS steps): k-means priming, one
    ``rq_quantize_train`` a step for the first and none for the second (the
    plain per-level loop), ``rq_tokenize`` in the eval, the loss finite and
    falling; ``rq_quantize_train`` and ``rq_tokenize`` against their twins at
    D = 64 on the run's own operands; one fp32 step of each config on the
    card against the CPU on a batch of the config's 64 rows, the Gumbel
    uniforms injected (the card's and the CPU's generators draw other
    streams). Returns (result, ML-32M checkpoint, ML-1M checkpoint, at_shapes
    entries for the two quantizer kernels)."""
    import torch

    from rqvae_tpu_torch.data import dataset as dataset_lib
    from rqvae_tpu_torch.data import registry
    from rqvae_tpu_torch.models import quantize, rqvae
    from rqvae_tpu_torch.ops import quantize_kernels as qk
    from rqvae_tpu_torch.train import checkpoint, optim
    from rqvae_tpu_torch.train import train_rqvae as tr
    from rqvae_tpu_torch.utils.tree import tree_map

    res, at_shapes, ckpts = {}, {}, {}
    for name, dataset in (("rqvae_ml32m", "ml32m"), ("rqvae_ml1m", "ml1m")):
        cfg = _ml_config(tr.RqVaeTrainConfig, name, [
            f"data_path={roots[dataset]}", f"iterations={ML_RQ_ITERS}",
            f"log_every={ML_RQ_ITERS // 6}",
            f"eval_every={ML_RQ_ITERS}", f"save_model_every={ML_RQ_ITERS}", f"seed={SEED}",
            f"save_dir_root={work}/{name}"])
        mcfg = cfg.model_config()
        primes, fused = [], {}
        real_prime, real_fused = rqvae.kmeans_prime, rqvae.rq_quantize_train

        def prime(*a, **kw):
            primes.append(1)
            return real_prime(*a, **kw)

        def record(x, cbs, mode, beta):
            fused.setdefault("x", x.detach().float().clone())
            fused.setdefault("cbs", cbs.detach().float().clone())
            return real_fused(x, cbs, mode, beta)

        counters = _launch_counters()
        rec = _Records()
        real_log = rec.log
        rec.log = lambda step, m, force=False: real_log(step, {   # noqa: E731
            **m, **{f"launches_{k}": c.launches for k, c in counters.items()}})
        rqvae.kmeans_prime, rqvae.rq_quantize_train = prime, record
        try:
            t0 = time.perf_counter()
            _, launches = _counted(lambda: tr.train(cfg, logger=rec, device=dev))
            wall_s = time.perf_counter() - t0
        finally:
            rqvae.kmeans_prime, rqvae.rq_quantize_train = real_prime, real_fused
        logs = [r for r in rec.records if "total_loss" in r]
        losses = [r["total_loss"] for r in logs]
        evals = [r for r in rec.records if "eval_total_loss" in r]
        a, b = logs[1], logs[-1]   # steps 50 and ML_RQ_ITERS: training only, before the eval
        per_step = (b["launches_rq_quantize_train"] - a["launches_rq_quantize_train"]) / (
            b["step"] - a["step"])
        want = 1 if name == "rqvae_ml32m" else 0
        check(per_step == want, f"phase 31 {name}: {per_step} rq_quantize_train a step, "
                                f"expected {want}")
        check(len(primes) == 1, f"phase 31 {name}: k-means priming ran {len(primes)} times")
        check(all(math.isfinite(x) for x in losses) and sum(losses[-2:]) / 2 < losses[0],
              f"phase 31 {name} losses {losses}")
        check(len(evals) == 1 and math.isfinite(evals[0]["eval_total_loss"])
              and launches.get("rq_tokenize", 0) > 0,
              f"phase 31 {name}: eval {evals}, launches {launches}")
        entry = dict(embed_dim=mcfg.embed_dim, mode=str(mcfg.codebook_mode), batch=cfg.batch_size,
                     iterations=ML_RQ_ITERS, losses=losses, wall_s=wall_s,
                     step_ms=_step_ms(rec.records), launches=launches,
                     rq_quantize_train_per_step=per_step,
                     eval={k: v for k, v in evals[0].items() if k != "t" and "launches" not in k})

        # one fp32 step on the card against the CPU, the Gumbel uniforms injected
        state, _ = checkpoint.restore(cfg.save_dir_root, device="cpu")
        bundle = registry.load(cfg.dataset, roots[dataset], need_seqs=False)
        # rows whose code chain has no near-tie (1e-4), which sums taken in
        # another order could flip
        pool = torch.from_numpy(dataset_lib.features_for_model(
            bundle.items.filtered("train")[:4 * cfg.batch_size], mcfg.input_dim))
        with torch.no_grad():
            z = rqvae.encode(state["params"], mcfg, pool).float()
            zcb = rqvae.effective_codebooks(state["params"], mcfg).float()
            near = _near_ties(z, zcb, qk.rq_quantize_train_plain(z, zcb).sem_ids, rel=1e-4)
        x = pool[~near][:cfg.batch_size][None]
        check(x.shape[1] == cfg.batch_size,
              f"phase 31 {name}: {x.shape[1]} rows without a near-tie")
        gen = torch.Generator().manual_seed(SEED + 31)
        draws = [torch.rand((cfg.batch_size, mcfg.codebook_size), generator=gen)
                 for _ in range(mcfg.n_layers)]
        real_sample = quantize.gumbel_softmax_sample
        out = {}
        for where in (dev, torch.device("cpu")):
            feed = iter(draws)
            quantize.gumbel_softmax_sample = lambda logits, t, **kw: real_sample(   # noqa: E731
                logits, t, uniform=next(feed).to(logits.device))
            try:
                opt = _Recorded(optim.adamw(cfg.learning_rate, cfg.weight_decay))
                p = tree_map(lambda t: t.to(where).clone(), state["params"])
                step = tr.make_train_step(mcfg, opt, 1, torch.float32)
                _, _, m = step(p, opt.init(p), x.to(where), None, cfg.gumbel_temperature)
                out[where.type] = (float(m["total_loss"]), opt.grads[0])
            finally:
                quantize.gumbel_softmax_sample = real_sample
        (lg, gg), (lc, gc) = out[dev.type], out["cpu"]
        loss_rel = abs(lg - lc) / abs(lc)
        check(loss_rel <= 1e-4, f"phase 31 {name} GPU vs CPU loss {lg} vs {lc}")
        entry["gpu_vs_cpu"] = dict(rows=cfg.batch_size, loss_rel_err=loss_rel,
                                   worst_grad_leaf=_grads_close(
                                       gg, gc, 1e-3, f"phase 31 {name} GPU vs CPU gradients"))
        res[name] = entry
        ckpts[name] = cfg.save_dir_root
        log(f"phase 31, {name}: {entry}")

        if name == "rqvae_ml32m":
            xs, cbs = fused["x"], fused["cbs"]
            check(tuple(xs.shape) == (cfg.batch_size, 64), f"recorded operands {tuple(xs.shape)}")
            with torch.no_grad():
                k_out = qk.rq_quantize_train(xs, cbs, "ROTATION_TRICK", mcfg.commitment_weight)
                p_out = qk.rq_quantize_train_plain(xs, cbs,
                                                   commitment_weight=mcfg.commitment_weight)
            near = _near_ties(xs, cbs, p_out.sem_ids)
            differ = (k_out.sem_ids != p_out.sem_ids).any(-1)
            check(not bool((differ & ~near).any()), "phase 31 rq_quantize_train ids off near-ties")
            err = 0.0
            for field in ("embeddings", "residuals", "quantize_loss"):
                ka, pa = getattr(k_out, field)[~differ], getattr(p_out, field)[~differ]
                check(torch.allclose(ka, pa, rtol=1e-5, atol=1e-5),
                      f"phase 31 rq_quantize_train {field} differs from its twin")
                err = max(err, float((ka - pa).abs().max()))
            timed = _rq_timed("rq_quantize_train",
                              lambda: qk.rq_quantize_train(xs, cbs, "ROTATION_TRICK", 0.25),
                              lambda: qk.rq_quantize_train_plain(xs, cbs, commitment_weight=0.25),
                              xs, cbs)
            at_shapes["rq_quantize_train"] = {"rqvae_ml32m_64x3x256x64": dict(
                timed, max_abs_err=err, rows_differ=int(differ.sum()),
                near_tie_rows=int(near.sum()))}
            # rq_tokenize on a corpus chunk of the trained model, as the eval and phase 32 run it
            params = tree_map(lambda t: t.to(dev), state["params"])
            corpus = torch.from_numpy(dataset_lib.features_for_model(
                bundle.items.x[:4096], mcfg.input_dim)).to(dev)
            z = rqvae.encode(params, mcfg, corpus).float().contiguous()
            zcbs = rqvae.effective_codebooks(params, mcfg).float().contiguous()
            k_tok = qk.rq_tokenize(z, zcbs, commitment_weight=mcfg.commitment_weight)
            held = _hold_rq_tokenize(z, zcbs, mcfg.commitment_weight, k_tok)
            timed = _rq_timed("rq_tokenize", lambda: qk.rq_tokenize(z, zcbs),
                              lambda: qk.rq_tokenize_plain(z, zcbs), z, zcbs)
            at_shapes["rq_tokenize"] = {"rqvae_ml32m_4096x3x256x64": dict(
                timed, rows_differ=held[0], near_tie_rows=held[1], max_abs_err=held[3])}
        del state
        torch.cuda.empty_cache()
    return res, ckpts["rqvae_ml32m"], ckpts["rqvae_ml1m"], at_shapes


def _ml_decoder_cfg(roots: dict, rq_ckpt: str, save: str, iterations: int, *extra):
    """``configs/decoder_ml32m.json`` as shipped (batch 64, 2 length buckets,
    dropout 0.1, 384 wide, 6 heads, 8 layers, fp32) on the ML-32M fixture's
    artifacts over phase 31's RQ-VAE; evals (one batch each) and a
    checkpoint at the end."""
    from rqvae_tpu_torch.train import train_decoder as td

    return _ml_config(td.DecoderTrainConfig, "decoder_ml32m", [
        f"data_path={roots['ml32m']}", f"pretrained_rqvae_path={rq_ckpt}",
        f"save_dir_root={save}", f"iterations={iterations}", f"seed={SEED}", "log_every=10",
        f"partial_eval_every={iterations}", f"full_eval_every={iterations}",
        f"save_model_every={iterations}", "eval_batches=1", *extra, *ML_DEC_EXTRA])


def _bucket_recorder(td):
    """Wrap ``td.bucket_slices``: every call's encoder tokens a bucket."""
    calls, real = [], td.bucket_slices

    def record(lengths, n_buckets, grid=4):
        out = real(lengths, n_buckets, grid)
        calls.append([4 * int(length) + 1 for _, length in out])
        return out

    return calls, record, real


def _ml_train(cfg, dev):
    """``train_decoder.train(cfg)`` counted: (records with each log's launch
    counts, launches of the whole run, wall s, the params it returns)."""
    from rqvae_tpu_torch.train import train_decoder as td

    counters = _launch_counters()
    rec = _Records()
    real_log = rec.log
    rec.log = lambda step, m, force=False: real_log(step, {   # noqa: E731
        **m, **{f"launches_{k}": c.launches for k, c in counters.items()}})
    t0 = time.perf_counter()
    params, launches = _counted(lambda: td.train(cfg, logger=rec, device=dev))
    return rec.records, launches, time.perf_counter() - t0, params


def _per_step(records, name: str) -> float:
    """A kernel's launches a step between the second and the last training
    log (before the end's evals)."""
    logs = [r for r in records if "total_loss" in r]
    a, b = logs[1], logs[-1]
    return (b[f"launches_{name}"] - a[f"launches_{name}"]) / (b["step"] - a["step"])


def _ml_decoder(dev, work: str, roots: dict, rq_ckpt: str) -> dict:
    """Phase 32: ``configs/decoder_ml32m.json`` as shipped through
    ``train_decoder.train`` (ML_DEC_ITERS steps, an eval batch, a checkpoint,
    then ML_DEC_RESUME_ITERS resumed steps): the 785-token bucket on the flat
    flash kernels and the short one on the route ``attend`` picks (the dense
    ``sdpa`` below 256 tokens), counted a step against the buckets' tokens;
    the loss finite and falling; ``children_window_mask`` and
    ``rq_tokenize`` in the generative eval; two fp32 bucketed steps at
    dropout 0 on ML_CPU_USERS users, the card against the CPU, each from the
    card's state (loss 1e-4 relative, gradients ``_grads_close``); every flat
    launch of the run on the fp32 tensor-core route, and those kernels held
    and timed on the long bucket's layer-0 operands (``_fp32_row``).
    Returns (result, that row)."""
    import numpy as np
    import torch

    from rqvae_tpu_torch.data import dataset as dataset_lib
    from rqvae_tpu_torch.data import registry
    from rqvae_tpu_torch.tokenizer import semids
    from rqvae_tpu_torch.train import checkpoint, optim
    from rqvae_tpu_torch.train import train_decoder as td
    from rqvae_tpu_torch.utils.tree import tree_map

    save = f"{work}/decoder_ml32m"
    cfg = _ml_decoder_cfg(roots, rq_ckpt, save, ML_DEC_ITERS)
    check((cfg.batch_size, cfg.length_buckets, cfg.dropout_p, cfg.attn_embed_dim, cfg.attn_heads,
           cfg.attn_layers, cfg.amp) == (64, 2, 0.1, 384, 6, 8, False),
          f"decoder_ml32m.json is not as shipped: {cfg}")
    buckets, record, real_slices = _bucket_recorder(td)
    td.bucket_slices = record
    try:
        _zero_routes()
        with _flash_recorder(256) as rec:
            records, launches, wall_s, _ = _ml_train(cfg, dev)
        routes = _routes_used()
        resumed = _ml_train(_ml_decoder_cfg(roots, rq_ckpt, save, ML_DEC_RESUME_ITERS), dev)[0]
    finally:
        td.bucket_slices = real_slices
    # every flat launch of the run (steps and evals) on the fp32 tensor-core route
    check(routes == {n: {"tf32x3": launches.get(n, 0)} for n in ("flash_attention_fwd",
                                                          "flash_attention_bwd")},
          f"phase 32 routes {routes}, launches {launches}")
    logs = [r for r in records if "total_loss" in r]
    losses = [r["total_loss"] for r in logs]
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"phase 32 losses {losses}")
    # the launches a step against the buckets' tokens: 4 flat flash forward
    # and backward (the encoder's layers) for each bucket of 256 tokens or more
    a, b = logs[1]["step"], logs[-1]["step"]
    big = sum(sum(t >= 256 for t in step) for step in buckets[a:b])
    got = {k: logs[-1][f"launches_{k}"] - logs[1][f"launches_{k}"]
           for k in ("flash_attention_fwd", "flash_attention_bwd")}
    check(got == {"flash_attention_fwd": 4 * big, "flash_attention_bwd": 4 * big},
          f"phase 32 flash launches {got} over steps {a + 1}-{b}, {big} buckets >= 256 tokens")
    evals = [r for r in records if "eval_loss" in r]
    gen_evals = [r for r in records if "ndcg@10" in r]
    check(len(evals) == len(gen_evals) == 1 and math.isfinite(evals[0]["eval_loss"])
          and all(0.0 <= v <= 1.0 for k, v in gen_evals[0].items() if k.startswith(("h@", "ndcg")))
          and launches.get("children_window_mask", 0) > 0 and launches.get("rq_tokenize", 0) > 0,
          f"phase 32 evals {evals} {gen_evals}, launches {launches}")
    resumed_steps = [r["step"] for r in resumed if "total_loss" in r]
    check(resumed_steps[:1] == [ML_DEC_ITERS + 1]
          and checkpoint.latest_step(save) == ML_DEC_ITERS + ML_DEC_RESUME_ITERS - 1,
          f"phase 32 resume: steps {resumed_steps}, checkpoint {checkpoint.latest_step(save)}")
    tokens = [t for step in buckets[:ML_DEC_ITERS] for t in step]
    out = dict(batch=cfg.batch_size, iterations=ML_DEC_ITERS, wall_s=wall_s, losses=losses,
               step_ms=_step_ms(records), launches=launches,
               bucket_tokens={"long_max": max(s[0] for s in buckets[:ML_DEC_ITERS]),
                              "short_max": max(s[1] for s in buckets[:ML_DEC_ITERS]),
                              "long_mean": float(np.mean([s[0] for s in buckets[:ML_DEC_ITERS]])),
                              "short_mean": float(np.mean([s[1] for s in buckets[:ML_DEC_ITERS]])),
                              "steps_with_a_short_flash_bucket": sum(
                                  s[1] >= 256 for s in buckets[:ML_DEC_ITERS])},
               flash_launches_per_step={k: v / (b - a) for k, v in got.items()},
               dense_attention_buckets_per_step=(len(tokens) - sum(t >= 256 for t in tokens))
               / ML_DEC_ITERS,
               eval={k: v for k, v in evals[0].items() if k != "t" and "launches" not in k},
               generative_eval={k: v for k, v in gen_evals[0].items()
                                if k != "t" and "launches" not in k},
               resumed_first_step=resumed_steps[0], routes=routes)
    row = _fp32_row("flat", rec["q"], rec["k"], rec["v"], rec["g"].contiguous(), 4,
                    k_mask=rec["k_mask"], causal=rec["causal"])
    log(f"phase 32 fp32 kernels on the long bucket's layer-0 operands: {row}")
    del rec
    torch.cuda.empty_cache()

    # two fp32 bucketed steps at dropout 0, the card against the CPU
    bundle = registry.load(registry.RecDataset.ML_32M, roots["ml32m"])
    model_cfg = dataclasses.replace(cfg.retrieval_config(bundle.max_seq_len), dropout=0.0,
                                    input_dropout=0.0)
    vae_params, vae_cfg = td.load_frozen_rqvae(cfg, device=dev)
    index = semids.precompute_corpus_ids(vae_params, vae_cfg, torch.from_numpy(
        dataset_lib.features_for_model(bundle.items.x, vae_cfg.input_dim)).to(dev))
    state, _ = checkpoint.restore(save, device="cpu")
    # eval rows: their targets are held-out items (a train row's target is
    # the -1 its crop appends unless the crop ends inside the window)
    raws = [bundle.eval_seqs.batch_at(np.arange(i * ML_CPU_USERS, (i + 1) * ML_CPU_USERS))
            for i in range(2)]
    opt_gpu = optim.adamw(optim.inv_sqrt_schedule(cfg.learning_rate, cfg.warmup_steps),
                          cfg.weight_decay)
    start = (state["params"], opt_gpu.init(state["params"]))
    steps = []
    for raw in raws:
        # both devices step from the card's state: AdamW's first updates are
        # near lr * sign(g), so a last-bit gradient difference in a leaf's
        # near-zero entries would move the next step's start by ~lr there
        res = {}
        for where in (dev, torch.device("cpu")):
            idx = semids.CorpusIndex(index.cached_ids.to(where), index.sorted_keys.to(where),
                                     index.bases, index.codebook_size, index.n_distinct)
            opt = _Recorded(opt_gpu)
            p = tree_map(lambda t: t.to(where).clone(), start[0])
            s = start[1]._replace(mu=tree_map(lambda t: t.to(where).clone(), start[1].mu),
                                  nu=tree_map(lambda t: t.to(where).clone(), start[1].nu))
            grad_fn, apply_fn = td.make_bucketed_fns(model_cfg, opt, idx, torch.float32,
                                                     model_cfg.sem_id_dim)
            grads = tree_map(torch.zeros_like, p)
            loss = torch.zeros((), device=where)
            loss_d = torch.zeros((model_cfg.sem_id_dim,), device=where)
            lengths = (raw["ids"] >= 0).sum(axis=1)
            for rows, length in td.bucket_slices(lengths, cfg.length_buckets):
                sub = {"user_ids": raw["user_ids"][rows], "ids": raw["ids"][rows, :length],
                       "ids_fut": raw["ids_fut"][rows]}
                grads, loss, loss_d = grad_fn(p, grads, loss, loss_d, dataset_lib.to_device(
                    dataset_lib.make_seq_batch(sub, bundle.items.x, with_features=False), where),
                    None, 1.0 / cfg.length_buckets)
            p, s = apply_fn(p, s, grads, loss)
            res[where.type] = (float(loss), opt.grads[0], (p, s))
        (lg, gg, nxt), (lc, gc, _) = res[dev.type], res["cpu"]
        loss_rel = abs(lg - lc) / abs(lc)
        check(loss_rel <= 1e-4, f"phase 32 step {len(steps)} GPU vs CPU loss {lg} vs {lc}")
        steps.append(dict(loss_rel_err=loss_rel, worst_grad_leaf=_grads_close(
            gg, gc, 1e-3, f"phase 32 step {len(steps)} GPU vs CPU gradients")))
        start = nxt
    out["gpu_vs_cpu"] = dict(users=ML_CPU_USERS, steps=steps)
    log(f"phase 32, decoder_ml32m.json through train(): {out}")
    return out, row


def _ml_branches(dev, work: str, roots: dict, rq_ckpt: str) -> tuple:
    """Phase 33: ``train()``'s other branches on the ML-32M artifacts, the
    config otherwise as shipped: (a) ``packed_rows`` = ML_PACK_ROWS (8 slots
    a row; ``length_buckets`` 1, as the packed branch requires): 4 span
    forward and 4 span backward launches a step and no flat flash, each
    span kernel against its twin on the step's layer-0 encoder operands;
    (b) ``gradient_accumulate_every`` = 2: 8 + 8 flat flash launches a step,
    and on the card the accumulating step's first update equals one flat
    step on the whole batch at dropout 0 (fp32, leaves 1e-3 of max-abs).
    Every flat and span launch of both runs takes the fp32 tensor-core
    route; the span kernels are held and timed on (a)'s layer-0 operands
    (``_fp32_row``). Returns (result, at_shapes entries of the span kernels,
    that row)."""
    import numpy as np
    import torch

    from rqvae_tpu_torch.data import dataset as dataset_lib
    from rqvae_tpu_torch.data import registry
    from rqvae_tpu_torch.data.schemas import SeqBatch
    from rqvae_tpu_torch.ops import attention as attn_ops
    from rqvae_tpu_torch.ops import flash_attention as fa
    from rqvae_tpu_torch.tokenizer import semids
    from rqvae_tpu_torch.train import checkpoint, optim
    from rqvae_tpu_torch.train import train_decoder as td
    from rqvae_tpu_torch.utils.tree import tree_leaves, tree_map

    out = {}
    # ---- (a) the packed branch ----
    seen = []
    real_spans, real_plain = attn_ops.flash_attention_spans, attn_ops.flash_attention_spans_plain

    def record(fn):
        def wrapped(q, k, v, lo, hi, extra):
            if not seen and q.requires_grad:
                seen.append((q.detach(), k.detach(), v.detach(), lo, hi, extra))
            return fn(q, k, v, lo, hi, extra)
        return wrapped

    attn_ops.flash_attention_spans = record(real_spans)
    attn_ops.flash_attention_spans_plain = record(real_plain)   # the CPU rehearsal's route
    try:
        cfg = _ml_decoder_cfg(roots, rq_ckpt, f"{work}/packed", ML_BRANCH_ITERS,
                              "length_buckets=1", f"packed_rows={ML_PACK_ROWS}", "log_every=2")
        _zero_routes()
        records, launches, wall_s, _ = _ml_train(cfg, dev)
        routes = _routes_used()
    finally:
        attn_ops.flash_attention_spans = real_spans
        attn_ops.flash_attention_spans_plain = real_plain
    per = {k: _per_step(records, k) for k in ("flash_attention_spans_fwd",
                                              "flash_attention_spans_bwd",
                                              "flash_attention_fwd", "flash_attention_bwd")}
    losses = [r["total_loss"] for r in records if "total_loss" in r]
    check(per == {"flash_attention_spans_fwd": 4, "flash_attention_spans_bwd": 4,
                  "flash_attention_fwd": 0, "flash_attention_bwd": 0},
          f"phase 33 packed launches a step {per}")
    check(all(math.isfinite(x) for x in losses), f"phase 33 packed losses {losses}")
    # every span launch of the run on the fp32 tensor-core route (the flat
    # ones: the evals' unpacked batches)
    check(all(r == {"tf32x3": launches.get(n, 0)} for n, r in routes.items())
          and {"flash_attention_spans_fwd", "flash_attention_spans_bwd"} <= set(routes),
          f"phase 33 packed routes {routes}, launches {launches}")
    q, k, v, lo, hi, extra = seen[0]
    g = torch.randn(q.shape, generator=torch.Generator(device=q.device).manual_seed(SEED + 33),
                    device=q.device).to(q.dtype)
    outs = []
    for fn in (fa.flash_attention_spans, fa.flash_attention_spans_plain):
        qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
        o = fn(qq, kk, vv, lo, hi, extra)
        outs.append([o.detach()] + [t.detach() for t in torch.autograd.grad(o, (qq, kk, vv), g)])
    errs = {n: float((a.float() - b.float()).abs().max()) / max(float(b.float().abs().max()), 1e-12)
            for n, a, b in zip(("out", "dq", "dk", "dv"), *outs)}
    tol = 1e-4 if q.dtype == torch.float32 else 2e-2
    check(max(errs.values()) <= tol, f"phase 33 span kernels vs twins {errs}")
    span_shape = {"shape": list(q.shape), "dtype": str(q.dtype), "rel_err": errs}
    out["packed"] = dict(rows=ML_PACK_ROWS, slots=cfg.pack_slots, iterations=ML_BRANCH_ITERS,
                         wall_s=wall_s, step_ms=_step_ms(records), losses=losses,
                         launches_per_step=per, twins=span_shape, routes=routes)
    row = _fp32_row("spans", q, k, v, g, 4, lo=lo, hi=hi, extra=extra)
    log(f"phase 33 fp32 span kernels on the packed step's layer-0 operands: {row}")
    del q, k, v, g, outs
    torch.cuda.empty_cache()

    # ---- (b) gradient accumulation ----
    cfg = _ml_decoder_cfg(roots, rq_ckpt, f"{work}/accum", ML_BRANCH_ITERS,
                          "length_buckets=1", "gradient_accumulate_every=2", "log_every=2")
    _zero_routes()
    records, launches, wall_s, _ = _ml_train(cfg, dev)
    accum_routes = _routes_used()
    per = {k: _per_step(records, k) for k in ("flash_attention_fwd", "flash_attention_bwd")}
    losses = [r["total_loss"] for r in records if "total_loss" in r]
    check(per == {"flash_attention_fwd": 8, "flash_attention_bwd": 8}
          and all(math.isfinite(x) for x in losses),
          f"phase 33 accumulation: launches a step {per}, losses {losses}")
    check(accum_routes == {n: {"tf32x3": launches.get(n, 0)} for n in ("flash_attention_fwd",
                                                                "flash_attention_bwd")},
          f"phase 33 accumulation routes {accum_routes}, launches {launches}")
    # the first update of the accumulating step against one flat step on the whole batch
    bundle = registry.load(registry.RecDataset.ML_32M, roots["ml32m"])
    model_cfg = dataclasses.replace(cfg.retrieval_config(bundle.max_seq_len), dropout=0.0,
                                    input_dropout=0.0)
    vae_params, vae_cfg = td.load_frozen_rqvae(cfg, device=dev)
    index = semids.precompute_corpus_ids(vae_params, vae_cfg, torch.from_numpy(
        dataset_lib.features_for_model(bundle.items.x, vae_cfg.input_dim)).to(dev))
    state, _ = checkpoint.restore(f"{work}/decoder_ml32m", device=dev)
    raw = bundle.eval_seqs.batch_at(np.arange(32))   # held-out targets, as in phase 32
    whole = dataset_lib.make_seq_batch(raw, bundle.items.x, with_features=False)
    halves = SeqBatch(*(np.stack([a[:16], a[16:]]) for a in whole))
    res = {}
    for accum, batch in ((2, halves), (1, SeqBatch(*(a[None] for a in whole)))):
        opt = _Recorded(optim.adamw(optim.inv_sqrt_schedule(cfg.learning_rate, cfg.warmup_steps),
                                    cfg.weight_decay))
        p = tree_map(lambda t: t.clone(), state["params"])
        step = td.make_train_step(model_cfg, opt, index, accum, torch.float32,
                                  model_cfg.sem_id_dim)
        p, _, m = step(p, opt.init(p), dataset_lib.to_device(batch, dev), None)
        res[accum] = (float(m["total_loss"]), opt.grads[0], tree_leaves(p))
    loss_rel = abs(res[2][0] - res[1][0]) / abs(res[1][0])
    check(loss_rel <= 1e-4, f"phase 33 accumulated loss {res[2][0]} vs flat {res[1][0]}")
    grad_rel = _grads_close(res[2][1], res[1][1], 1e-3, "phase 33 accumulated gradients")
    # the updated leaves where the gradient is not near zero: AdamW's first
    # update is ~lr * sign(g), so where g is near zero a last-bit gradient
    # difference moves an entry by up to 2 lr (~1.7e-3 of a leaf's max-abs)
    worst, skipped = 0.0, 0
    for (_, g), a, b in zip(res[1][1], res[2][2], res[1][2]):
        live = ((g.abs() >= 1e-3 * g.abs().max()) | (g == 0)).to(b.device)
        err = float((a - b)[live].abs().max()) if bool(live.any()) else 0.0
        scale = float(b.abs().max())
        check(err <= 1e-3 * scale + 1e-12, f"phase 33 accumulated update: {err} of {scale}")
        worst, skipped = max(worst, err / scale if scale else 0.0), skipped + int((~live).sum())
    out["accumulate"] = dict(gradient_accumulate_every=2, iterations=ML_BRANCH_ITERS,
                             wall_s=wall_s, step_ms=_step_ms(records), losses=losses,
                             launches_per_step=per, routes=accum_routes,
                             first_update_vs_flat=dict(rows=32, loss_rel_err=loss_rel,
                                                       worst_grad_leaf=grad_rel,
                                                       worst_leaf_rel_err=worst,
                                                       near_zero_gradient_entries=skipped))
    log(f"phase 33, train()'s packed and accumulating branches: {out}")
    return out, span_shape, row


def _ml1m_decoder(dev, work: str, roots: dict, rq_ckpt: str) -> tuple:
    """Phase 34: ``configs/decoder_ml1m.json`` as shipped (batch 128, 8 heads
    x 64, 512 wide, 4 + 4 layers, 801 tokens, fp32, dropout 0.3) through
    ``train_decoder.train`` on the ML-1M fixture's artifacts over phase 31's
    Gumbel RQ-VAE: ML1M_DEC_ITERS steps, an eval batch, a checkpoint. The
    loss finite and falling; 4 + 4 flat flash launches a step, every flat
    launch of the run on the fp32 tensor-core route; the kernels held and
    timed on the first step's layer-0 encoder operands (``_fp32_row``); one
    traced step from the checkpoint (device busy time, idle share); one fp32
    step at dropout 0 on ML_CPU_USERS eval rows, the card against the CPU
    from the card's state (loss 1e-4 relative, gradients ``_grads_close``
    1e-3). Returns (result, the kernels' row)."""
    import numpy as np
    import torch

    from rqvae_tpu_torch.data import dataset as dataset_lib
    from rqvae_tpu_torch.data import registry
    from rqvae_tpu_torch.tokenizer import semids
    from rqvae_tpu_torch.train import checkpoint, optim
    from rqvae_tpu_torch.train import train_decoder as td
    from rqvae_tpu_torch.utils.tree import tree_map

    save = f"{work}/decoder_ml1m"
    cfg = _ml_config(td.DecoderTrainConfig, "decoder_ml1m", [
        f"data_path={roots['ml1m']}", f"pretrained_rqvae_path={rq_ckpt}", f"save_dir_root={save}",
        f"iterations={ML1M_DEC_ITERS}", f"seed={SEED}", "log_every=5",
        f"partial_eval_every={ML1M_DEC_ITERS}", f"full_eval_every={ML1M_DEC_ITERS}",
        f"save_model_every={ML1M_DEC_ITERS}", "eval_batches=1", *ML_DEC_EXTRA])
    check((cfg.batch_size, cfg.length_buckets, cfg.dropout_p, cfg.attn_embed_dim, cfg.attn_heads,
           cfg.attn_layers, cfg.amp) == (128, 1, 0.3, 512, 8, 8, False),
          f"decoder_ml1m.json is not as shipped: {cfg}")
    _zero_routes()
    with _flash_recorder(256) as rec:
        records, launches, wall_s, _ = _ml_train(cfg, dev)
    routes = _routes_used()
    logs = [r for r in records if "total_loss" in r]
    losses = [r["total_loss"] for r in logs]
    check(all(math.isfinite(x) for x in losses) and sum(losses[-2:]) / 2 < losses[0],
          f"phase 34 losses {losses}")
    per = {k: _per_step(records, k) for k in ("flash_attention_fwd", "flash_attention_bwd")}
    check(per == {"flash_attention_fwd": 4, "flash_attention_bwd": 4},
          f"phase 34 flash launches a step {per}")
    check(routes == {n: {"tf32x3": launches.get(n, 0)} for n in ("flash_attention_fwd",
                                                          "flash_attention_bwd")},
          f"phase 34 routes {routes}, launches {launches}")
    evals = [r for r in records if "eval_loss" in r]
    gen_evals = [r for r in records if "ndcg@10" in r]
    check(len(evals) == len(gen_evals) == 1 and math.isfinite(evals[0]["eval_loss"])
          and all(0.0 <= v <= 1.0 for k, v in gen_evals[0].items() if k.startswith(("h@", "ndcg")))
          and checkpoint.latest_step(save) == ML1M_DEC_ITERS - 1,
          f"phase 34 evals {evals} {gen_evals}, checkpoint {checkpoint.latest_step(save)}")
    out = dict(batch=cfg.batch_size, iterations=ML1M_DEC_ITERS, wall_s=wall_s, losses=losses,
               step_ms=_step_ms(records), launches=launches, flash_launches_per_step=per,
               routes=routes,
               eval={k: v for k, v in evals[0].items() if k != "t" and "launches" not in k},
               generative_eval={k: v for k, v in gen_evals[0].items()
                                if k != "t" and "launches" not in k})
    row = _fp32_row("flat", rec["q"], rec["k"], rec["v"], rec["g"].contiguous(), 4,
                    k_mask=rec["k_mask"], causal=rec["causal"])
    log(f"phase 34 fp32 kernels on the first step's layer-0 operands: {row}")
    del rec
    torch.cuda.empty_cache()

    # one traced step of the config from the checkpoint, and one fp32 step at
    # dropout 0, the card against the CPU
    bundle = registry.load(registry.RecDataset.ML_1M, roots["ml1m"])
    model_cfg = cfg.retrieval_config(bundle.max_seq_len)
    vae_params, vae_cfg = td.load_frozen_rqvae(cfg, device=dev)
    index = semids.precompute_corpus_ids(vae_params, vae_cfg, torch.from_numpy(
        dataset_lib.features_for_model(bundle.items.x, vae_cfg.input_dim)).to(dev))
    state, _ = checkpoint.restore(save, device=dev)
    opt = optim.adamw(optim.inv_sqrt_schedule(cfg.learning_rate, cfg.warmup_steps),
                      cfg.weight_decay)
    rows = np.arange(min(cfg.batch_size, len(bundle.train_seqs)))
    batch = dataset_lib.to_device(dataset_lib.make_seq_batch(
        bundle.train_seqs.batch_at(rows), bundle.items.x, with_features=False), dev)
    batch = type(batch)(*(t[None] for t in batch))
    step = td.make_train_step(model_cfg, opt, index, 1, torch.float32, model_cfg.sem_id_dim)
    traced = [tree_map(lambda t: t.clone(), state["params"])]
    traced.append(opt.init(traced[0]))
    gen = torch.Generator(device=dev).manual_seed(SEED + 34)

    def one_step():
        traced[0], traced[1], _ = step(traced[0], traced[1], batch, gen)

    out["step_profile"] = _profile(one_step, top=8)
    del traced, batch
    torch.cuda.empty_cache()
    cfg0 = dataclasses.replace(model_cfg, dropout=0.0, input_dropout=0.0)
    raw = bundle.eval_seqs.batch_at(np.arange(ML_CPU_USERS))
    res = {}
    for where in (dev, torch.device("cpu")):
        idx = semids.CorpusIndex(index.cached_ids.to(where), index.sorted_keys.to(where),
                                 index.bases, index.codebook_size, index.n_distinct)
        rec_opt = _Recorded(opt)
        p = tree_map(lambda t: t.to(where).clone(), state["params"])
        one = td.make_train_step(cfg0, rec_opt, idx, 1, torch.float32, cfg0.sem_id_dim)
        b1 = dataset_lib.to_device(dataset_lib.make_seq_batch(raw, bundle.items.x,
                                                              with_features=False), where)
        _, _, m = one(p, rec_opt.init(p), type(b1)(*(t[None] for t in b1)), None)
        res[where.type] = (float(m["total_loss"]), rec_opt.grads[0])
    (lg, gg), (lc, gc) = res[dev.type], res["cpu"]
    loss_rel = abs(lg - lc) / abs(lc)
    check(loss_rel <= 1e-4, f"phase 34 GPU vs CPU loss {lg} vs {lc}")
    out["gpu_vs_cpu"] = dict(users=ML_CPU_USERS, loss_rel_err=loss_rel, worst_grad_leaf=_grads_close(
        gg, gc, 1e-3, "phase 34 GPU vs CPU gradients"))
    log(f"phase 34, decoder_ml1m.json through train(): {out}")
    return out, row


def _tp_one_process(dev):
    """Phases 29 and 30's one-process reference: the ML-32M flat step of
    ``_tp_ml32m_inputs`` in fp32 and bf16 on the card. Returns (model
    config, {dtype name: loss, gradients, launches, step ms})."""
    import torch

    cfg, index, flat, params = _tp_ml32m_inputs(dev)
    one = {}
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        loss, grads, launches, _, _, ms = _tp_ml32m_step(cfg, index, flat, params, dtype, dev)
        one[name] = dict(loss=loss, grads=grads, launches=launches, step_ms=ms)
    del params, flat, index
    torch.cuda.empty_cache()
    return cfg, one


def _hold_tp_ml32m(phase: str, r: int, res: dict, saved_path: str, one: dict, heads: int,
                   m: int) -> dict:
    """A rank's ML-32M flat steps (fp32, bf16) against one process: fp32
    loss 1e-4 relative and gathered gradients 1e-3 of each leaf's max-abs;
    bf16 loss 2e-2 and gradients as ``_bf16_leaves_close`` says; 4 flat
    flash forward and 4 backward launches a step on ``heads`` heads a rank,
    each kernel against its twin on the rank's operands (fp32 1e-4, bf16
    2e-2 of the max-abs)."""
    import torch

    check(res["world"] == m and res["backend"] == "gloo" and res["mesh"]["tp"] == m
          and res["mesh"]["model_index"] == r, f"{phase} rank {r}: {res['mesh']}")
    saved = torch.load(saved_path, weights_only=False)
    out = {}
    for name, rel in (("fp32", 1e-4), ("bf16", 2e-2)):
        a = res["ml32m"][name]
        loss_rel = abs(a["loss"] - one[name]["loss"]) / abs(one[name]["loss"])
        check(loss_rel <= rel, f"{phase} rank {r} {name} loss {a['loss']} vs {one[name]['loss']}")
        if name == "fp32":
            leaf = _leaves_close(saved[name], one[name]["grads"], 1e-3,
                                 f"{phase} rank {r} fp32 gradients")
        else:
            leaf = _bf16_leaves_close(saved[name], one["bf16"]["grads"], one["fp32"]["grads"],
                                      f"{phase} rank {r} bf16")
        check(a["launches"].get("flash_attention_fwd") == 4
              and a["launches"].get("flash_attention_bwd") == 4,
              f"{phase} rank {r} {name} launches {a['launches']}")
        tw = a["twins"]
        tol = 1e-4 if name == "fp32" else 2e-2
        check(tw["heads"] == heads and max(tw["rel_err"].values()) <= tol,
              f"{phase} rank {r} {name} flash vs twin: {tw}")
        out[name] = dict(loss_rel=loss_rel, leaf_rel=leaf, step_ms=a["step_ms"],
                         launches=a["launches"], collectives=a["collectives"],
                         data_collectives=a["data_collectives"], twins=tw)
    return out


def _tp4_train(rq_ckpt: str, work: str, dev) -> tuple:
    """Phase 30 (b) on one rank: ``configs/decoder_ml32m.json`` through
    ``train_decoder.train`` with ``tensor_parallel=true`` and ``mesh_shape``
    [1, 4] for TP4_ITERS steps on the artifacts at ``ML_DATA``, its evals
    and checkpoint at the end. Returns (its records, launches, buckets'
    tokens and wall s; the whole parameters on the host)."""
    from rqvae_tpu_torch.parallel import mesh
    from rqvae_tpu_torch.train import train_decoder as td

    cfg = _ml_decoder_cfg({"ml32m": ML_DATA}, rq_ckpt, f"{work}/tp4_train", TP4_ITERS,
                          "tensor_parallel=true", "mesh_shape=[1,4]", "log_every=2")
    buckets, record, real_slices = _bucket_recorder(td)
    td.bucket_slices = record
    try:
        records, launches, wall_s, params = _ml_train(cfg, dev)
    finally:
        td.bucket_slices = real_slices
    whole = mesh.fetch_to_host(params, mesh.retrieval_tp_spec, cfg.attn_heads)   # a collective
    return dict(records=records, launches=launches, buckets=buckets, wall_s=wall_s), whole


def _tp4(dev, work: str, roots: dict, rq_ckpt: str, smi: str) -> dict:
    """Phase 30: four ranks of this script share the card over gloo at mesh
    (1, 4) with ``tensor_parallel``, where ML-32M's 6 heads do not divide
    and every rank computes all of them on whole attention leaves: (a) the
    ML-32M flat step at ``configs/decoder_ml32m.json``'s width (batch cut to
    TP_ML_BATCH, dropout 0) in fp32 and bf16 against one process on the card
    (``_hold_tp_ml32m``: 4 + 4 flash launches a rank on 6 heads, each kernel
    against its twin on the rank's operands); (b) TP4_ITERS steps of
    ``train_decoder.train`` on the ML-32M artifacts over phase 31's RQ-VAE,
    the flat flash launches a step against the buckets' tokens, the loss
    finite, the evals in range, and its checkpoint restored into one
    process equal to the ranks' gathered leaves, bit for bit."""
    import torch

    from rqvae_tpu_torch.train import checkpoint
    from rqvae_tpu_torch.utils.tree import tree_leaves

    cfg, one = _tp_one_process(dev)
    ranks = _dp_launch("tp4", work, 4, dev, rq_ckpt, timeout=600, flag="--tp-worker",
                       extra={"ML_DATA": roots["ml32m"]})
    out = dict(card=smi, mesh=[1, 4], heads=cfg.num_heads, ranks=[],
               one_process={f"ml32m_{n}": dict(loss=one[n]["loss"], step_ms=one[n]["step_ms"],
                                               launches=one[n]["launches"]) for n in one})
    for r, res in enumerate(ranks):
        entry = dict(ml32m=_hold_tp_ml32m("phase 30", r, res, f"{work}/tp4_r{r}.pt", one,
                                          cfg.num_heads, 4))
        tr = res["train"]
        logs = [x for x in tr["records"] if "total_loss" in x]
        losses = [x["total_loss"] for x in logs]
        a, b = logs[1]["step"], logs[-1]["step"]
        big = sum(sum(t >= 256 for t in step) for step in tr["buckets"][a:b])
        got = {k: logs[-1][f"launches_{k}"] - logs[1][f"launches_{k}"]
               for k in ("flash_attention_fwd", "flash_attention_bwd")}
        evals = {k: v for x in tr["records"] for k, v in x.items() if k.startswith(("h@", "ndcg"))}
        check(all(math.isfinite(x) for x in losses) and len(losses) >= 3
              and got == {"flash_attention_fwd": 4 * big, "flash_attention_bwd": 4 * big}
              and evals and all(0.0 <= v <= 1.0 for v in evals.values()),
              f"phase 30 rank {r} train(): losses {losses}, flash {got} for {big} long buckets, "
              f"eval {evals}")
        entry["train"] = dict(losses=losses, step_ms=_step_ms(tr["records"]),
                              wall_s=tr["wall_s"], launches=tr["launches"],
                              flash_launches_per_step={k: v / (b - a) for k, v in got.items()},
                              eval=evals)
        out["ranks"].append(entry)
    saved = torch.load(f"{work}/tp4_r0.pt", weights_only=False)
    state, meta = checkpoint.restore(f"{work}/tp4_train", device="cpu")
    check(meta["step"] == TP4_ITERS - 1, f"phase 30 checkpoint step {meta['step']}")
    for a, b in zip(tree_leaves(state["params"]), tree_leaves(saved["decoder_params"])):
        check(torch.equal(a, b), "phase 30 checkpoint leaf differs from the ranks' gathered one")
    out["checkpoint_restores_whole"] = True
    log(f"phase 30, 6 heads at mesh (1, 4): {out}")
    return out


def _bf16_leaves_close(got, want, want32, what: str) -> float:
    """bf16 gradient leaves against one process's bf16 ones: each within 2e-2
    of the leaf's max-abs, or within twice what bf16 itself moves the leaf
    on one process (against its fp32 gradients), whichever is larger, since
    the ranks round their partial products to bf16 before they sum them.
    Returns the worst error over 2e-2 of the max-abs."""
    from rqvae_tpu_torch.utils.tree import tree_leaves

    worst = 0.0
    for a, b, c in zip(tree_leaves(got), tree_leaves(want), tree_leaves(want32)):
        a, b, c = (t.float().cpu() for t in (a, b, c))
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        own = float((b - c).abs().max())
        check(err <= max(2e-2 * scale, 2 * own) + 1e-12,
              f"{what}: a leaf differs by {err} of {scale} (bf16 on one process: {own})")
        worst = max(worst, err / (2e-2 * scale) if scale else 0.0)
    return worst


if __name__ == "__main__":
    sys.exit(main())
