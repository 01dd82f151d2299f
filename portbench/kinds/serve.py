"""Beam-search serving in a closed loop on one card: one client sends its
next call when the last one has returned. A call takes the next users of a
seeded order, builds their batch on the host (``batch_at``,
``make_seq_batch``, ``to_device``), tokenizes it against the corpus index
(``tokenize_sequences``) and runs ``generate_next_sem_ids``; its latency
runs from the call to the ``torch.cuda.synchronize()`` after it.

Set-up makes the items (unit 768-d vectors), the RQ-VAE's and the
decoder's weights from the seed, and has the port build the corpus index
(``precompute_corpus_ids``: ``rq_tokenize``, the dedup column, the prefix
tables). After the window the reference judges a sample of the calls it
finished (drawn from the seed, the one with the longest history in it):

* ``corpus_mismatch``: items whose tuple in the program's index is not the
  reference's (near-ties aside, ``reference/corpus.py``);
* ``invalid_beams``: served beams with no penalty whose tuple is no item;
* ``rescore_gap``: the largest gap between a served beam's score and the
  score the reference gives its tuple (beams with no penalty);
* ``top1_gap``: by how much the best served beam, rescored, lies below the
  reference search's best (0 when it does not).
"""
from __future__ import annotations

import gc
import os
import resource
import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import counts, reference, traffic
from portbench.kinds.train import _sync, seeds
from portbench.reference import corpus as ref_corpus
from portbench.reference import model as ref_model
from portbench.reference import search as ref_search
from portbench.reference import train as ref_train

UNPENALISED = -5000.0   # a beam below this score took a token the corpus does not allow


def make_items(gen: torch.Generator, n: int, dim: int, device) -> torch.Tensor:
    x = torch.randn((n, dim), generator=gen, device=gen.device).to(device)
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def last_items(ids: np.ndarray, n: int) -> np.ndarray:
    """Each row's last ``n`` items, left-aligned and -1 padded to ``n``."""
    out = np.full((ids.shape[0], n), -1, np.int32)
    lengths = (ids >= 0).sum(axis=1)
    for r, m in enumerate(lengths):
        keep = ids[r, max(0, m - n):m]
        out[r, :len(keep)] = keep
    return out


def prepare(ctx) -> SimpleNamespace:
    from rqvae_tpu_torch.data import dataset as dataset_lib
    from rqvae_tpu_torch.models import generation
    from rqvae_tpu_torch.tokenizer import semids
    from rqvae_tpu_torch.train import train_decoder as td
    from rqvae_tpu_torch.utils import config as config_lib

    cfg, mix, dev = ctx.config, ctx.traffic, ctx.device
    s_data, s_weights, s_rq, s_order = seeds(ctx.seed)
    dcfg = config_lib.from_dict(td.DecoderTrainConfig, cfg["decoder"])
    max_len = int(cfg["max_seq_len"])
    model_cfg = dcfg.retrieval_config(max_len)
    n_items = int(cfg["n_items"])
    rq_gen = torch.Generator(device=dev).manual_seed(s_rq)
    items = make_items(rq_gen, n_items, int(cfg["rqvae"]["vae_input_dim"]), dev)
    rq_params = ref_corpus.init_rqvae(rq_gen, cfg["rqvae"], items)
    with torch.no_grad():
        index = semids.precompute_corpus_ids(rq_params, dcfg.vae_config(), items)
    rng = np.random.default_rng(s_data)
    ids, fut, owner = traffic.histories(rng, mix, n_items)
    ids = last_items(ids, max_len)
    seqs = dataset_lib.SeqDataset(user_ids=owner, item_ids=ids, item_ids_fut=fut,
                                  max_seq_len=max_len)
    shape = ref_model.decoder_shape(cfg["decoder"], max_len)
    params = ref_model.init_decoder(torch.Generator(device=dev).manual_seed(s_weights), shape, dev)
    bs, k = int(mix["batch"]), int(mix["k"])
    order = np.random.default_rng(s_order).permutation(len(owner))
    lengths = (ids >= 0).sum(axis=1)

    def rows_of(j: int) -> np.ndarray:
        """The users of call ``j``: the next ``bs`` of the seeded order."""
        return order[np.arange(j * bs, (j + 1) * bs) % len(order)]

    def one_call(j: int):
        """Call ``j``: the search of its users. Returns its latency (s), its
        answer (beams, scores, on the device) and where its time went (s:
        the host batch and tokenization, the search's enqueue, the wait for
        the card, the process's CPU time)."""
        rows = rows_of(j)
        c0, t0 = time.process_time(), time.perf_counter()
        b = dataset_lib.to_device(
            dataset_lib.make_seq_batch(seqs.batch_at(rows), None, with_features=False), dev)
        tok = semids.tokenize_sequences(index, b)
        t1 = time.perf_counter()
        out = generation.generate_next_sem_ids(
            params, model_cfg, index, tok._replace(sem_ids_fut=None, token_type_ids_fut=None),
            None, k=k, n_candidates=int(mix["candidates"]), temperature=1.0)
        t2 = time.perf_counter()
        _sync(dev)
        t3 = time.perf_counter()
        return t3 - t0, (out.sem_ids, out.log_probas), (t1 - t0, t2 - t1, t3 - t2,
                                                       time.process_time() - c0)

    warmup = int(mix.get("warmup_calls", 3))
    for j in range(warmup):
        one_call(j)
    return SimpleNamespace(ctx=ctx, one_call=one_call, rows_of=rows_of, calls=warmup,
                           lengths=lengths, index=index, items=items, rq_params=rq_params,
                           params=params, shape=shape, ids=ids, owner=owner, bs=bs, k=k,
                           seeds=(s_data, s_weights, s_rq, s_order),
                           count_shape=counts.shape_of(shape),
                           dtype="bfloat16" if dcfg.amp else "float32")


class Sample:
    """The calls the check judges, drawn from ``seed`` while the window runs
    so that only theirs of the answers are kept: the first call that holds
    a history of the corpus's longest length (or, till one comes, the call
    with the longest so far), and ``n - 1`` of the others by reservoir
    sampling."""

    def __init__(self, n: int, seed: int, longest: int):
        self.n, self.longest = n, longest
        self.rng = np.random.default_rng(seed)
        self.top = None          # (length, j, rows, answer)
        self.rest = []           # [(j, rows, answer)]
        self.seen = 0

    def offer(self, j: int, rows: np.ndarray, length: int, answer) -> None:
        if self.top is None or (self.top[0] < self.longest and length > self.top[0]):
            self.top = (length, j, rows, answer)
            return
        self.seen += 1
        if len(self.rest) < self.n - 1:
            self.rest.append((j, rows, answer))
        else:
            r = int(self.rng.integers(self.seen))
            if r < self.n - 1:
                self.rest[r] = (j, rows, answer)

    def answers(self):
        """[(rows, beams, scores)] of the sampled calls, the longest first."""
        picked = ([] if self.top is None else [self.top[1:]]) + sorted(self.rest, key=lambda x: x[0])
        return [(rows, *answer) for _, rows, answer in picked]


def _allocator():
    if not torch.cuda.is_available():
        return {}
    st = torch.cuda.memory_stats()
    return {k: st.get(k, 0) for k in ("num_alloc_retries", "num_device_alloc", "num_device_free",
                                      "reserved_bytes.all.current")}


def window(cell, seconds: float) -> dict:
    """Calls back to back for ``seconds``; the sampled calls' answers are
    kept, every other answer is dropped as a server drops it once sent. An
    earlier line names the slowest calls and where their time went (the
    host's batch, the search's enqueue, the wait for the card, CPU time,
    involuntary context switches, garbage collection), and the allocator's
    and the host's state around the window."""
    pauses, mark = [], [0.0]   # (start, seconds) of each collection; the running one's start

    def on_gc(phase, info):
        if phase == "start":
            mark[0] = time.perf_counter()
        else:
            pauses.append((mark[0], time.perf_counter() - mark[0]))

    pick = Sample(int(cell.ctx.traffic.get("check_calls", 4)), cell.seeds[3] + 1,
                  int(cell.lengths.max()))
    lat, parts, starts = [], [], []
    first = cell.calls
    alloc0, load0 = _allocator(), os.getloadavg()
    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    gc.callbacks.append(on_gc)
    _sync(cell.ctx.device)
    t0 = time.perf_counter()
    while True:
        j = cell.calls
        starts.append(time.perf_counter())
        ivcsw = resource.getrusage(resource.RUSAGE_SELF).ru_nivcsw
        seconds_j, answer, part = cell.one_call(j)
        parts.append(part + (resource.getrusage(resource.RUSAGE_SELF).ru_nivcsw - ivcsw,))
        lat.append(seconds_j)
        cell.calls += 1
        rows = cell.rows_of(j)
        pick.offer(j, rows, int(cell.lengths[rows].max()), answer)
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    gc.callbacks.remove(on_gc)
    ru1 = resource.getrusage(resource.RUSAGE_SELF)
    alloc1, load1 = _allocator(), os.getloadavg()
    cell.window_calls = range(first, cell.calls)
    cell.sample = pick
    users = len(lat) * cell.bs
    flops = sum(counts.search_flops(cell.count_shape, cell.lengths[cell.rows_of(j)], cell.k)
                for j in cell.window_calls)
    print(f"# window: {len(lat)} calls, latency p50 {1e3 * np.median(lat):.3f} ms, max "
          f"{1e3 * max(lat):.3f} ms", flush=True)
    for i in np.argsort(lat)[::-1][:3]:
        gc_ms = sum(d for s, d in pauses if starts[i] <= s < starts[i] + lat[i])
        b, e, w, cpu, sw = parts[i]
        print(f"# slow call at {starts[i] - t0:.3f} s: {1e3 * lat[i]:.3f} ms = batch {1e3 * b:.3f} "
              f"+ enqueue {1e3 * e:.3f} + wait {1e3 * w:.3f}; cpu {1e3 * cpu:.3f} ms, "
              f"involuntary switches {sw}, gc {1e3 * gc_ms:.3f} ms", flush=True)
    print(f"# around the window: allocator {alloc0} -> {alloc1}; load {load0} -> {load1}; "
          f"cpu {ru1.ru_utime + ru1.ru_stime - ru0.ru_utime - ru0.ru_stime:.3f} s, involuntary "
          f"switches {ru1.ru_nivcsw - ru0.ru_nivcsw}, gc {len(pauses)} collections "
          f"{1e3 * sum(d for _, d in pauses):.3f} ms", flush=True)
    return {"window": {"seconds": elapsed, "steps": len(lat), "queries": users, "flops": flops,
                       "peak_flops": counts.PEAK_FLOPS[cell.dtype]},
            "latencies_s": lat,
            "end_to_end": {"queries_per_s": users / elapsed,
                           "search_p95_ms": 1e3 * float(np.percentile(lat, 95))}}


def traced(cell, calls: int) -> dict:
    from portbench import trace

    bound = []
    width = cell.ids.shape[1]

    def body():
        rows = cell.rows_of(cell.calls)
        cell.one_call(cell.calls)
        cell.calls += 1
        bound.append(sum(counts.bound_s(call, "fwd", cell.dtype) for call in counts.search_attention_calls(
            cell.count_shape, (cell.ids[rows] >= 0).sum(axis=1), width, cell.k)))

    tr = trace.profile(body, calls)
    return {"kernels": tr.kernels, "busy_s": tr.busy_s, "window_s": tr.window_s, "gaps": tr.gaps,
            "attn_bound_s": sum(bound[1:]), "steps": calls, "_trace": tr}


def reference_corpus(cell, program_codes, tf32: bool = False):
    """(tuples (n, D) of the reference, mismatches against ``program_codes``
    (n, D) or None)."""
    with reference.precision(tf32):
        codes, bad = ref_corpus.tokenize(
            cell.rq_params, cell.items, None if program_codes is None else program_codes[:, :-1])
    tuples = torch.cat([codes, ref_corpus.dedup(codes)[:, None]], dim=1)
    if program_codes is not None:
        differ = (program_codes.long() != tuples).any(dim=1)
        bad = int(differ.sum())
    return tuples, bad


def reference_search(cell, tuples, rows, tf32: bool = False):
    """The reference's beams (tuples, scores) for the users ``rows``."""
    s = cell.shape
    hist = cell.ids[rows]
    with reference.precision(tf32), torch.no_grad():
        sem, mask, _ = ref_train.tokens(tuples, hist, np.zeros(len(rows), np.int64))
        users = torch.from_numpy(cell.owner[rows]).to(tuples.device)
        ctx, ctx_mask = ref_model.history_context(cell.params, s, sem, mask, users)
        pre = ref_corpus.Prefixes(tuples, s.codebook)
        return ref_search.beam_search(cell.params, s, ctx, ctx_mask, pre, cell.k), (ctx, ctx_mask, pre)


def judge_calls(cell, tuples, mismatches, answers) -> dict:
    """The serving numbers for ``answers``: [(rows, beams, scores)]."""
    s = cell.shape
    invalid, rescore, top1 = 0, 0.0, 0.0
    for rows, beams, scores in answers:
        (_, ref_scores), (ctx, ctx_mask, pre) = reference_search(cell, tuples, rows)
        with reference.precision(False), torch.no_grad():
            again = ref_search.rescore(cell.params, s, ctx, ctx_mask, pre, beams.long())
        scores = scores.float()
        live = scores > UNPENALISED
        ok = pre.contains(beams.reshape(-1, s.sem_dim).long()).reshape(live.shape)
        invalid += int((live & ~ok).sum())
        both = live & (again > UNPENALISED)
        if bool(both.any()):
            rescore = max(rescore, float(torch.max(torch.abs(scores - again)[both])))
        best = torch.where(both, again, ref_search.PENALTY * s.sem_dim).max(dim=1).values
        top1 = max(top1, float(torch.clamp(ref_scores[:, 0] - best, min=0).max()))
    return {"corpus_mismatch": mismatches, "invalid_beams": invalid, "rescore_gap": rescore,
            "top1_gap": top1}


def run(ctx) -> dict:
    cell = prepare(ctx)
    setup_s = ctx.clock()
    rec = window(cell, ctx.seconds)
    if ctx.trace:
        rec["trace"] = traced(cell, int(ctx.traffic.get("trace_calls", 3)))
    peak = torch.cuda.max_memory_allocated() if ctx.device.type == "cuda" else 0
    program_codes = cell.index.cached_ids
    answers = cell.sample.answers()
    tuples, bad = reference_corpus(cell, program_codes)
    nums = judge_calls(cell, tuples, bad, answers)
    return {"setup_s": setup_s, "record": rec, "numbers": nums, "attempted": rec["window"]["steps"],
            "failed": 0, "memory_peak_bytes": peak}
