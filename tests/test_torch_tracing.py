"""The port's span and counter recorder (``utils/profiling``): off by
default and then free of work at the sites, nesting and request ids,
per-thread stacks, counters and ``collect()``, the documented names a
bucketed train step and a beam search emit, and the mapping of span times
onto a ``torch.profiler`` chrome trace's clock (CPU), with a
``StepProfiler`` window's counters written into its trace."""
import json
import threading
import time

import numpy as np
import pytest
import torch

from rqvae_tpu_torch.data import dataset as dataset_lib
from rqvae_tpu_torch.models import generation, retrieval
from rqvae_tpu_torch.tokenizer import semids
from rqvae_tpu_torch.train import optim
from rqvae_tpu_torch.train import train_decoder as ttd
from rqvae_tpu_torch.utils import profiling
from rqvae_tpu_torch.utils.tree import tree_map

K = 16
N_ITEMS = 60
N_HIST = 12
CFG = retrieval.RetrievalConfig(embedding_dim=16, attn_dim=32, dropout=0.0, num_heads=2,
                                n_layers=2, num_embeddings=K, sem_id_dim=4, max_pos=N_HIST * 4,
                                input_dropout=0.0, mlp_hidden_dim=32)


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with recording off and nothing kept."""
    profiling.disable()
    profiling.collect()
    yield
    profiling.disable()
    profiling.collect()


def _empty(rec):
    return rec["spans"] == [] and rec["counters"] == {}


def _names(rec):
    return [s[0] for s in rec["spans"]]


def _by_name(rec):
    return {s[0]: dict(zip(profiling.SPAN_FIELDS, s)) for s in rec["spans"]}


def test_off_records_nothing_and_computes_no_argument(monkeypatch):
    """Off: one shared no-op, nothing recorded, and the sites whose arguments
    cost work (a batch's counts, an attention call's shapes) do none of it:
    with those made to raise, the sites still run."""
    from rqvae_tpu_torch.ops import attention as tattn

    a, b = profiling.span("x"), profiling.span("y", level=1)
    assert a is b is profiling.OFF
    with profiling.span("x"):
        profiling.count("c", 3)

    def boom(*args, **kwargs):
        raise AssertionError("an argument computed with recording off")

    monkeypatch.setattr(profiling, "count", boom)
    monkeypatch.setattr(tattn, "attention_span", boom)
    batch = dataset_lib.make_seq_batch(_seqs().batch_at(np.arange(4)), None, with_features=False)
    q = torch.randn(2, 5, 2, 16)
    tattn.attend(q, q, q, causal=True)
    assert _empty(profiling.collect())
    profiling.enable()
    with pytest.raises(AssertionError, match="recording off"):
        dataset_lib.make_seq_batch(_seqs().batch_at(np.arange(4)), None, with_features=False)
    with pytest.raises(AssertionError, match="recording off"):
        tattn.attend(q, q, q, causal=True)
    assert batch.seq_mask.shape == (4, N_HIST)


def test_nesting_parents_and_request_ids():
    profiling.enable()
    with profiling.span("root", step=7):
        with profiling.span("a"):
            with profiling.span("b"):
                pass
        with profiling.span("c"):
            pass
    with profiling.span("root2"):
        pass
    rec = profiling.collect()
    assert _names(rec) == ["root", "a", "b", "c", "root2"]   # by start
    s = _by_name(rec)
    assert s["root"]["parent"] == 0 and s["root"]["request"] == s["root"]["id"]
    assert s["a"]["parent"] == s["root"]["id"] and s["b"]["parent"] == s["a"]["id"]
    assert s["c"]["parent"] == s["root"]["id"]
    assert {s[n]["request"] for n in "abc"} == {s["root"]["id"]}
    assert s["root2"]["request"] == s["root2"]["id"] != s["root"]["id"]
    assert s["root"]["args"] == {"step": 7}
    for inner, outer in (("a", "root"), ("b", "a"), ("c", "root")):
        assert s[outer]["start_ns"] <= s[inner]["start_ns"] <= s[inner]["end_ns"] <= s[outer]["end_ns"]
    # Unix nanoseconds
    assert abs(s["root"]["start_ns"] - time.time_ns()) < 60e9
    assert s["root"]["tid"] == threading.get_native_id()
    assert rec["threads"][threading.get_native_id()] == threading.get_ident()


def test_per_thread_stacks():
    profiling.enable()
    started, release = threading.Event(), threading.Event()

    def other():
        with profiling.span("worker"):
            started.set()
            release.wait(10)

    with profiling.span("main"):
        t = threading.Thread(target=other)
        t.start()
        started.wait(10)
        with profiling.span("main.child"):
            pass
        release.set()
        t.join()
    rec = profiling.collect()
    s = _by_name(rec)
    assert s["worker"]["parent"] == 0 and s["worker"]["request"] == s["worker"]["id"]
    assert s["worker"]["tid"] != s["main"]["tid"]
    assert s["main.child"]["parent"] == s["main"]["id"]
    assert rec["threads"][s["worker"]["tid"]] == t.ident


def test_counters_and_collect_clears():
    profiling.enable()
    profiling.count("c", 3)
    profiling.count("c", 4)
    profiling.count("d")
    with profiling.span("x"):
        pass
    rec = profiling.collect()
    assert rec["counters"] == {"c": 7, "d": 1} and _names(rec) == ["x"]
    assert _empty(profiling.collect())
    profiling.disable()
    profiling.count("c", 1)
    with profiling.span("y"):
        pass
    assert _empty(profiling.collect())


def _index_params():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, K, (N_ITEMS, 3)).astype(np.int32)
    cached = np.concatenate([ids, np.zeros((N_ITEMS, 1), np.int32)], axis=1)
    cached[:, -1] = semids.dedup_column(torch.from_numpy(ids), K).numpy()
    index = semids.build_index(torch.from_numpy(cached), K)
    return index, retrieval.init(torch.Generator().manual_seed(0), CFG, device="cpu")


def _seqs():
    rng = np.random.RandomState(1)
    lengths = rng.randint(1, N_HIST + 1, 8)
    ids = rng.randint(0, N_ITEMS, (8, N_HIST)).astype(np.int32)
    ids = np.where(np.arange(N_HIST)[None] < lengths[:, None], ids, -1)
    return dataset_lib.SeqDataset(user_ids=np.arange(8, dtype=np.int32), item_ids=ids,
                                  item_ids_fut=rng.randint(0, N_ITEMS, (8, 1)).astype(np.int32),
                                  max_seq_len=N_HIST)


def _tree(rec):
    """[(depth, name)] in start order, depth from the parent links."""
    depth = {}
    out = []
    for name, _, _, sid, parent, *_ in rec["spans"]:
        depth[sid] = depth.get(parent, -1) + 1
        out.append((depth[sid], name))
    return out


def test_bucketed_step_emits_the_documented_names():
    index, params = _index_params()
    opt = optim.adamw(1e-3, 0.01)
    opt_state = opt.init(params)
    grad_accum, apply = ttd.make_bucketed_fns(CFG, opt, index, torch.float32, 4)
    seqs = _seqs()
    profiling.enable()
    with profiling.span("train.step", step=0):
        raw = seqs.sample_batch(np.random.default_rng(0), 8, subsample=True)
        grads = tree_map(torch.zeros_like, params)
        loss, loss_d = torch.zeros(()), torch.zeros(4)
        for rows, length in ttd.bucket_slices((raw["ids"] >= 0).sum(axis=1), 2):
            sub = dataset_lib.make_seq_batch({"user_ids": raw["user_ids"][rows],
                                              "ids": raw["ids"][rows, :length],
                                              "ids_fut": raw["ids_fut"][rows]}, None,
                                             with_features=False)
            grads, loss, loss_d = grad_accum(params, grads, loss, loss_d,
                                             dataset_lib.to_device(sub, "cpu"), None, 0.5)
        apply(params, opt_state, grads, loss)
    rec = profiling.collect()
    assert set(_names(rec)) <= set(profiling.VOCABULARY)
    bucket = [(1, "data.batch"), (1, "data.to_device"), (1, "step.forward"),
              (2, "tokenize")] + [(2, "attn.fwd")] * 3 + [(1, "step.backward")]
    assert _tree(rec) == ([(0, "train.step"), (1, "data.sample"), (1, "data.bucket")] + bucket * 2
                          + [(1, "step.optimizer")])
    fwd = [s for s in rec["spans"] if s[0] == "attn.fwd"]   # one encoder, one decoder layer
    assert {s[7]["family"] for s in fwd} == {"sdpa"}     # 16-wide heads
    assert {(s[7]["H"], s[7]["Dh"], s[7]["dtype"]) for s in fwd} == {(2, 16, "float32")}
    assert sorted({s[7]["causal"] for s in fwd}) == [False, True]
    assert set(rec["counters"]) <= set(profiling.COUNTERS)
    groups = ttd.bucket_slices((raw["ids"] >= 0).sum(axis=1), 2)
    assert rec["counters"]["data.item_slots"] == sum(len(rows) * n for rows, n in groups)
    assert rec["counters"]["data.valid_items"] == int((raw["ids"] >= 0).sum())


def test_beam_search_emits_the_documented_names():
    index, params = _index_params()
    seqs = _seqs()
    profiling.enable()
    b = dataset_lib.to_device(dataset_lib.make_seq_batch(seqs.batch_at(np.arange(4)), None,
                                                         with_features=False), "cpu")
    tok = semids.tokenize_sequences(index, b)
    generation.generate_next_sem_ids(params, CFG, index,
                                     tok._replace(sem_ids_fut=None, token_type_ids_fut=None),
                                     k=3, n_candidates=K)
    rec = profiling.collect()
    assert set(_names(rec)) <= set(profiling.VOCABULARY)
    # one encoder and one decoder layer: the encoder's self-attention, then
    # each level's cached self- and cross-attention
    level = [(1, "search.level"), (2, "attn.fwd"), (2, "attn.fwd"), (2, "search.children_mask")]
    assert _tree(rec) == ([(0, "data.sample"), (0, "data.batch"), (0, "data.to_device"),
                           (0, "tokenize"), (0, "search"), (1, "search.encode"),
                           (2, "attn.fwd")] + level * 4)
    levels = [s[7]["level"] for s in rec["spans"] if s[0] == "search.level"]
    assert levels == [0, 1, 2, 3]


def test_span_times_map_onto_the_profiler_clock(tmp_path):
    """A span around a ``record_function`` encloses its ``user_annotation``
    event once mapped onto the chrome trace's clock."""
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.randn(64, 64)
    profiling.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(3):
            with profiling.span("mark", i=i):
                with record_function(f"mark{i}"):
                    x @ x
    rec = profiling.collect()
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    assert profiling.add_spans_to_chrome_trace(str(path), rec["spans"]) == 3
    events = json.loads(path.read_text())["traceEvents"]
    marks = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    spans = [e for e in events if e.get("cat") == "program_span"]
    assert len(spans) == 3
    for e in spans:
        m = marks[f"mark{e['args']['i']}"]
        assert e["tid"] == m["tid"]
        assert e["ts"] <= m["ts"] and m["ts"] + m["dur"] <= e["ts"] + e["dur"]


def test_step_profiler_writes_its_window_counters_into_the_trace(tmp_path):
    """The counters recorded while a ``profile_dir`` window is open reach its
    chrome trace as ``C`` events of the window's totals, at its end; those
    of steps outside the window do not."""
    seqs = _seqs()

    def batch(rows):
        return dataset_lib.make_seq_batch(seqs.batch_at(rows), None, with_features=False)

    prof = profiling.StepProfiler(str(tmp_path), start=1, num_steps=2, device="cpu")
    want = {"data.item_slots": 0, "data.valid_items": 0}
    for it in range(4):
        prof.step(it)
        rows = np.arange(it, it + 3)
        b = batch(rows)
        if 1 <= it < 3:
            want["data.item_slots"] += b.ids.size
            want["data.valid_items"] += int(b.seq_mask.sum())
    prof.close()
    assert want["data.valid_items"] > 0
    (path,) = tmp_path.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    got = {e["name"]: e for e in events if e.get("ph") == "C"}
    assert {n: e["args"][n] for n, e in got.items()} == want
    window = [e for e in events if e.get("cat") == "program_span"]
    assert [e["name"] for e in window] == ["data.sample", "data.batch"] * 2
    end = max(e["ts"] + e["dur"] for e in window)
    assert all(e["ts"] >= end and e["cat"] == "program_counter" for e in got.values())
    assert not profiling.enabled() and _empty(profiling.collect())


@pytest.mark.parametrize("family", ["flat", "small", "spans", "sdpa"])
def test_attention_spans_name_the_route(family, monkeypatch):
    """``attend`` records its route family and shapes; the flash autograd
    functions' backward records ``attn.bwd`` (their CPU twins run it here)."""
    from rqvae_tpu_torch.ops import attention as tattn
    from rqvae_tpu_torch.ops import flash_attention as tfa

    monkeypatch.setenv(tattn.SHORT_FLASH_ENV, "1")
    n = 300 if family in ("flat", "spans") else 9
    dh = 16 if family == "sdpa" else 64
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, n, 2, dh, generator=g, requires_grad=True) for _ in range(3))
    spans = None
    if family == "spans":
        spans = (torch.zeros(2, n, dtype=torch.int32), torch.full((2, n), n, dtype=torch.int32),
                 torch.full((2, n), -1, dtype=torch.int32))
    assert tattn.route(q, k, q_spans=spans) == family
    profiling.enable()
    tattn.attend(q, k, v, q_spans=spans)
    if family != "sdpa":
        fn = {"flat": tfa.flash_attention, "small": tfa.flash_attention_small,
              "spans": tfa.flash_attention_spans}[family]
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        out = fn(qh, kh, vh, *spans) if spans else fn(qh, kh, vh, causal=False)
        out.sum().backward()
    rec = profiling.collect()
    want = {"family": family, "B": 2, "H": 2, "Nq": n, "Nk": n, "Dh": dh, "dtype": "float32",
            "causal": False}
    assert [(s[0], s[7]) for s in rec["spans"]] == [("attn.fwd", want)] + (
        [] if family == "sdpa" else [("attn.bwd", want)])


def test_threads_lose_no_span_or_count():
    """More recording threads than cores, switching often: every span and
    every count arrives."""
    import os
    import sys

    n_threads, n = 2 * (os.cpu_count() or 4), 200
    profiling.enable()

    def work():
        for i in range(n):
            with profiling.span("t", i=i):
                profiling.count("c", 1)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    rec = profiling.collect()
    assert len(rec["spans"]) == n_threads * n and rec["counters"] == {"c": n_threads * n}
    assert len({s[3] for s in rec["spans"]}) == n_threads * n       # distinct ids
    assert all(s[4] == 0 for s in rec["spans"])                     # each thread's own roots
