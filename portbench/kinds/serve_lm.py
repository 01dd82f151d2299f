"""Beam-search serving of the decoder-only retriever on DeepSeek-V2's block
(``rqvae_tpu_torch.models.retrieval_lm``) in a closed loop on one card:
``kinds/serve.py``'s loop, users, corpus index and check, with the model
swapped. A call builds its users' batch on the host (``batch_at``,
``make_seq_batch``, ``to_device``), tokenizes it against the corpus index
(``tokenize_sequences``) and runs ``generate_next_sem_ids``, which prefills
the histories and decodes through their latent cache; its latency runs
from the call to the ``torch.cuda.synchronize()`` after it.

Set-up makes the items, the RQ-VAE's weights (the codebook size from the
configuration's ``decoder`` block) and the model's weights (bf16, from
``reference/lm.py``'s ``init_weights``) from the seed, and has the port
build the corpus index. ``--trace 1`` profiles ``trace_calls`` calls with
the port's spans and counters recorded and merges them with the trace
(``portbench/spans.py``).

After the window the check judges ``check_users`` users of the sampled
calls (``serve.Sample``; the longest history among them first), against
the plain reference in float32 on the same weights (``reference/lm.py``):
``corpus_mismatch``, ``invalid_beams``, ``rescore_gap`` and ``top1_gap`` as
``kinds/serve.py`` defines them, and two numbers from the port's forward
at the timed path's own sizes: each sampled call that holds a judged user
runs again on its whole batch (its prefill and the decode of all its beam
rows, each along its served beam), and the judged users' rows are kept.

* ``logit_gap``: along each judged user's served beams, at every level
  (the prefill's at level 0, then the decode through both caches), the
  largest RMS over the codes of program minus reference, over the RMS of
  the reference's logits;
* ``route_mismatch``: the share of the judged users' history tokens and
  expert layers (their prefill) whose set of routed experts is not the
  reference's. In bf16 a router near-tie may pick another last expert than
  the float32 reference: the limit leaves room for such pairs, and a
  routing fault (another top-k) moves every token.
"""
from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import counts, counts_lm, reference, spans, trace, traffic
from portbench.kinds import serve
from portbench.kinds.train import _sync, seeds
from portbench.reference import corpus as ref_corpus
from portbench.reference import lm as ref_lm


def prepare(ctx) -> SimpleNamespace:
    from rqvae_tpu_torch.data import dataset as dataset_lib
    from rqvae_tpu_torch.models import generation, retrieval_lm
    from rqvae_tpu_torch.tokenizer import semids
    from rqvae_tpu_torch.train import train_decoder as td
    from rqvae_tpu_torch.utils import config as config_lib

    cfg, mix, dev = ctx.config, ctx.traffic, ctx.device
    s_data, s_weights, s_rq, s_order = seeds(ctx.seed)
    dcfg = config_lib.from_dict(td.DecoderTrainConfig, cfg["decoder"])
    shape = ref_lm.lm_shape(cfg)
    model_cfg = retrieval_lm.config_from_deepseek(cfg, num_heads=shape.heads,
                                                  num_embeddings=shape.codebook,
                                                  sem_id_dim=shape.sem_dim)
    max_len, n_items = int(cfg["max_seq_len"]), int(cfg["n_items"])
    rq_gen = torch.Generator(device=dev).manual_seed(s_rq)
    items = serve.make_items(rq_gen, n_items, dcfg.vae_input_dim, dev)
    rq_params = ref_corpus.init_rqvae(
        rq_gen, dict(cfg["rqvae"], vae_codebook_size=dcfg.vae_codebook_size), items)
    with torch.no_grad():
        index = semids.precompute_corpus_ids(rq_params, dcfg.vae_config(), items)
    rng = np.random.default_rng(s_data)
    ids, fut, owner = traffic.histories(rng, mix, n_items)
    ids = serve.last_items(ids, max_len)
    seqs = dataset_lib.SeqDataset(user_ids=owner, item_ids=ids, item_ids_fut=fut,
                                  max_seq_len=max_len)
    # the configuration's precision on the card; a CPU run (the benchmark's own tests) computes
    # in float32, as the other cells' CPU runs take the kernels' plain float32 twins
    dtype = ({"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["precision"]]
             if dev.type == "cuda" else torch.float32)
    params = ref_lm.init_weights(torch.Generator(device=dev).manual_seed(s_weights), shape, dev,
                                 dtype)
    bs = int(mix["batch"])
    k = min(int(mix["k"]), shape.codebook)    # level 0 offers K tokens
    order = np.random.default_rng(s_order).permutation(len(owner))
    lengths = (ids >= 0).sum(axis=1)

    def rows_of(j: int) -> np.ndarray:
        return order[np.arange(j * bs, (j + 1) * bs) % len(order)]

    def batch_of(rows: np.ndarray):
        b = dataset_lib.to_device(
            dataset_lib.make_seq_batch(seqs.batch_at(rows), None, with_features=False), dev)
        return semids.tokenize_sequences(index, b)._replace(sem_ids_fut=None,
                                                            token_type_ids_fut=None)

    def search(tok):
        return generation.generate_next_sem_ids(params, model_cfg, index, tok, None, k=k,
                                                n_candidates=int(mix["candidates"]), temperature=1.0)

    def one_call(j: int):
        """Call ``j``: (latency s, (beams, scores) on the device, (host batch
        s, enqueue s, wait s))."""
        t0 = time.perf_counter()
        tok = batch_of(rows_of(j))
        t1 = time.perf_counter()
        out = search(tok)
        t2 = time.perf_counter()
        _sync(dev)
        t3 = time.perf_counter()
        return t3 - t0, (out.sem_ids, out.log_probas), (t1 - t0, t2 - t1, t3 - t2)

    warmup = int(mix.get("warmup_calls", 3))
    for j in range(warmup):
        one_call(j)
    return SimpleNamespace(ctx=ctx, one_call=one_call, search=search, rows_of=rows_of,
                           batch_of=batch_of, calls=warmup, lengths=lengths, index=index, items=items,
                           rq_params=rq_params, params=params, shape=shape, model_cfg=model_cfg,
                           ids=ids, owner=owner, bs=bs, k=k, seeds=(s_data, s_weights, s_rq, s_order),
                           dtype=cfg["precision"])


def window(cell, seconds: float) -> dict:
    """Calls back to back for ``seconds``, only the sampled calls' answers
    kept; an earlier line names the three slowest calls."""
    pick = serve.Sample(int(cell.ctx.traffic.get("check_calls", 4)), cell.seeds[3] + 1,
                        int(cell.lengths.max()))
    lat, parts, starts = [], [], []
    first = cell.calls
    _sync(cell.ctx.device)
    t0 = time.perf_counter()
    while True:
        j = cell.calls
        starts.append(time.perf_counter() - t0)
        seconds_j, answer, part = cell.one_call(j)
        lat.append(seconds_j)
        parts.append(part)
        cell.calls += 1
        rows = cell.rows_of(j)
        pick.offer(j, rows, int(cell.lengths[rows].max()), answer)
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    cell.sample = pick
    d = cell.shape.sem_dim
    flops = sum(counts_lm.search_flops(cell.shape, 1 + d * cell.lengths[cell.rows_of(j)], cell.k)
                for j in range(first, cell.calls))
    print(f"# window: {len(lat)} calls, latency p50 {1e3 * np.median(lat):.3f} ms, max "
          f"{1e3 * max(lat):.3f} ms", flush=True)
    for i in np.argsort(lat)[::-1][:3]:
        b, e, w = parts[i]
        print(f"# slow call at {starts[i]:.3f} s: {1e3 * lat[i]:.3f} ms = batch {1e3 * b:.3f} + "
              f"enqueue {1e3 * e:.3f} + wait {1e3 * w:.3f}", flush=True)
    users = len(lat) * cell.bs
    return {"window": {"seconds": elapsed, "steps": len(lat), "queries": users, "flops": flops,
                       "peak_flops": counts.PEAK_FLOPS[cell.dtype]},
            "latencies_s": lat,
            "end_to_end": {"queries_per_s": users / elapsed,
                           "search_p95_ms": 1e3 * float(np.percentile(lat, 95))}}


def traced(cell, calls: int) -> dict:
    """``calls`` calls under the profiler (after one unrecorded) with the
    port's spans and counters recorded: the trace's reduction
    (``trace.reduce``) and its merge with the spans (``spans.merge``, device
    ms a call by span), the slice's counters."""
    import json
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, schedule

    from rqvae_tpu_torch.utils import profiling

    def call():
        cell.one_call(cell.calls)
        cell.calls += 1

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[ProfilerActivity.CUDA],
                                    schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                                    on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
            call()
            torch.cuda.synchronize()
            prof.step()
            profiling.enable()
            with profiling.span(spans.MARKER):
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(calls):
                with profiling.span("serve.call", step=i):
                    call()
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
            got = profiling.collect()
            profiling.disable()
            prof.step()
        with open(path) as f:
            tr_json = json.load(f)
    finally:
        profiling.disable()
        os.unlink(path)
    events = tr_json["traceEvents"]
    tr = trace.reduce(events, window_s)
    merged = spans.merge(events, int(tr_json.get("baseTimeNanoseconds", 0)), got["spans"], calls,
                         "serve.call", threads=got.get("threads"))
    return {"kernels": tr.kernels, "busy_s": tr.busy_s, "window_s": tr.window_s, "gaps": tr.gaps,
            "steps": calls, "_trace": tr, "spans": merged, "counters": got["counters"],
            "expert_dims": [cell.shape.hidden, cell.shape.expert_width]}


def pick_users(cell, answers, n: int):
    """[(call, position)] of ``n`` users of the sampled calls' answers
    ([(rows, beams, scores)], the call with the longest history first):
    that call's longest history, then users drawn from the seed."""
    pool = [(c, i) for c, (rows, _, _) in enumerate(answers) for i in range(len(rows))]
    first = (0, int(np.argmax(cell.lengths[answers[0][0]])))
    rest = [u for u in pool if u != first]
    rng = np.random.default_rng(cell.seeds[3] + 2)
    return [first] + [rest[i] for i in rng.choice(len(rest), min(n, len(pool)) - 1, replace=False)]


def served(answers, picked):
    """[(dataset row, beams (k, D), scores (k,))] of the picked users."""
    return [(int(answers[c][0][i]), answers[c][1][i], answers[c][2][i]) for c, i in picked]


def served_logits(params, cfg, batch, beams: torch.Tensor, routes: list):
    """Logits (B, k, D, K) float32 of a call's whole batch along its served
    tuples ``beams`` (B, k, D): at level 0 the prefill's, at level i the
    decode through both caches of the beam's first i tokens (the search's
    path, its tokens fixed). ``routes`` gets the prefill's experts by expert
    layer; also returns the users' token counts (B,)."""
    from rqvae_tpu_torch.models import retrieval_lm

    b, k, d = beams.shape
    with torch.no_grad():
        logits, hist = retrieval_lm.prefill(params, cfg, batch, routes=routes)
        out = [logits.float()[:, None].expand(b, k, -1)]
        flat = beams.reshape(b * k, d)
        own = None
        for level in range(d - 1):
            logits, own = retrieval_lm.decode_step(params, cfg, hist, own, flat[:, level], level)
            out.append(logits.float().view(b, k, -1))
    return torch.stack(out, dim=2), hist.lengths


def program_outputs(cell, answers, picked):
    """The port's logits (U, k, D, K) along the picked users' served beams,
    and its experts of their history tokens, [(T, top_k)] by expert layer:
    each sampled call that holds a picked user runs again on its whole batch
    along all its served beams (``served_logits``), the picked users' rows
    kept."""
    logits, routes = [None] * len(picked), [[] for _ in picked]
    for c in sorted({c for c, _ in picked}):
        rows, beams, _ = answers[c]
        got = []
        lg, lengths = served_logits(cell.params, cell.model_cfg, cell.batch_of(rows), beams.long(),
                                    got)
        ends = torch.cumsum(lengths, 0).tolist()
        for u, (cu, i) in enumerate(picked):
            if cu == c:
                logits[u] = lg[i]
                lo = ends[i] - int(lengths[i])
                routes[u] = [layer[lo:ends[i]] for layer in got]
    return torch.stack(logits), [torch.cat(layer) for layer in zip(*routes)]


def reference_routes(params, s, users, hists):
    """The reference's experts of the histories' tokens, [(T, top_k)] by
    expert layer, user by user (one forward a history)."""
    per_user = []
    dev = params["head"].device
    with reference.precision(False), torch.no_grad():
        for u, (toks, lv) in zip(users, hists):
            got = []
            ref_lm.forward(params, s, torch.tensor([u], device=dev), torch.tensor([toks], device=dev),
                           torch.tensor([lv], device=dev), routes=got)
            per_user.append(got)
    return [torch.cat(layer) for layer in zip(*per_user)]


def route_mismatch(routes, want) -> float:
    """The share of (token, layer) whose expert sets differ."""
    differ = total = 0
    for a, b in zip(routes, want):
        total += b.shape[0]
        if a.shape != b.shape:
            differ += b.shape[0]
        else:
            differ += int((a.sort(dim=1).values != b.to(a.device).sort(dim=1).values).any(dim=1).sum())
    return differ / max(total, 1)


def judge(cell, tuples, mismatches, picked, logits, routes, ref_params) -> dict:
    """The check's numbers for the picked users, their served beams, the
    program's logits along them and its routes of their histories, against
    the reference on ``ref_params``."""
    s = cell.shape
    rows = [r for r, _, _ in picked]
    beams = torch.stack([b for _, b, _ in picked]).long().to(tuples.device)
    scores = torch.stack([sc for _, _, sc in picked]).float().to(tuples.device)
    users = cell.owner[rows].tolist()
    with reference.precision(False), torch.no_grad():
        hists = [ref_lm.history_tokens(tuples, cell.ids[r][cell.ids[r] >= 0]) for r in rows]
        pre = ref_corpus.Prefixes(tuples, s.codebook)
        _, ref_scores = ref_lm.beam_search(ref_params, s, users, hists, pre, cell.k)
        again, ref_logits = ref_lm.rescore(ref_params, s, users, hists, pre, beams)
    live = scores > serve.UNPENALISED
    ok = pre.contains(beams.reshape(-1, s.sem_dim)).reshape(live.shape)
    both = live & (again > serve.UNPENALISED)
    rescore = float(torch.max(torch.abs(scores - again)[both])) if bool(both.any()) else 0.0
    best = torch.where(both, again, ref_lm.PENALTY * s.sem_dim).max(dim=1).values
    top1 = float(torch.clamp(ref_scores[:, 0] - best, min=0).max())
    rms = lambda x: torch.sqrt(torch.mean(x.double() ** 2, dim=-1))  # noqa: E731
    gap = rms(logits.to(ref_logits.device) - ref_logits) / rms(ref_logits)
    want = reference_routes(ref_params, s, users, hists)
    return {"corpus_mismatch": mismatches, "invalid_beams": int((live & ~ok).sum()),
            "rescore_gap": rescore, "top1_gap": top1, "logit_gap": float(gap.max()),
            "route_mismatch": route_mismatch(routes, want)}


def check(cell) -> dict:
    """The check's numbers of the window's sampled calls."""
    answers = cell.sample.answers()
    picked = pick_users(cell, answers, int(cell.ctx.traffic.get("check_users", 32)))
    logits, routes = program_outputs(cell, answers, picked)
    tuples, bad = serve.reference_corpus(cell, cell.index.cached_ids)
    return judge(cell, tuples, bad, served(answers, picked), logits, routes,
                 ref_lm.as_float(cell.params))


def run(ctx) -> dict:
    cell = prepare(ctx)
    setup_s = ctx.clock()
    rec = window(cell, ctx.seconds)
    if ctx.trace:
        rec["trace"] = traced(cell, int(ctx.traffic.get("trace_calls", 3)))
    peak = torch.cuda.max_memory_allocated() if ctx.device.type == "cuda" else 0
    t0 = time.perf_counter()
    nums = check(cell)
    print(f"# check: {time.perf_counter() - t0:.3f} s", flush=True)
    return {"setup_s": setup_s, "record": rec, "numbers": nums, "attempted": rec["window"]["steps"],
            "failed": 0, "memory_peak_bytes": peak}
