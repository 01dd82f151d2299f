"""The port's spans merged with a profiler trace (``portbench/spans.py``) on
a made-up trace in the style of ``test_portbench_trace.py``: device ops put
down to spans by the runtime call that launched them (with the fallback
across threads), idle gaps put down to the span open at their middle, the
clock check and its refusal, and the values of the per-layer numbers,
which are None where the record lacks what they read."""
import random

import pytest

from portbench import spans

BASE = 1_700_000_000_000_000_000   # baseTimeNanoseconds
MAIN, AUTOGRAD = 11, 12            # OS thread ids
# the threads' get_ident(), and the ids a CUDA trace gives their runtime calls
THREADS = {MAIN: 0x7F074D373300, AUTOGRAD: 0x7F03A9FFF6C0}
TRACE_TID = {MAIN: 0x4D373300, AUTOGRAD: 1442842944}


def _span(name, a_us, b_us, sid, parent, tid, **args):
    return (name, BASE + int(a_us * 1e3), BASE + int(b_us * 1e3), sid, parent,
            sid if parent == 0 else 1, tid, args)


SPANS = [_span("clock.sync", 10, 30, 9, 0, MAIN),
         _span("train.step", 100, 1000, 1, 0, MAIN, step=0),
         _span("step.forward", 150, 400, 2, 1, MAIN),
         _span("attn.fwd", 200, 250, 3, 2, MAIN, family="small"),
         _span("step.backward", 400, 800, 4, 1, MAIN),
         _span("attn.bwd", 500, 550, 5, 0, AUTOGRAD, family="small"),
         _span("step.optimizer", 800, 950, 6, 1, MAIN)]


def _launch(corr, ts, tid):
    return {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 3,
            "tid": TRACE_TID[tid], "args": {"correlation": corr}}


def _kernel(corr, ts, dur, name="k"):
    return {"cat": "kernel", "name": name, "ts": ts, "dur": dur, "tid": "stream 7",
            "args": {"correlation": corr}}


def _events(sync_ts=15):
    return [{"cat": "cuda_runtime", "name": "cudaDeviceSynchronize", "ts": sync_ts, "dur": 10,
             "tid": TRACE_TID[MAIN], "args": {"correlation": 99}},
            _launch(5, 120, MAIN), _kernel(5, 130, 10),               # under the root alone
            _launch(1, 210, MAIN), _kernel(1, 300, 40, "small_fwd"),  # attn.fwd
            _launch(2, 420, AUTOGRAD), _kernel(2, 500, 100),          # no span on its thread then
            _launch(3, 520, AUTOGRAD), _kernel(3, 650, 50, "small_bwd"),  # attn.bwd
            _launch(4, 850, MAIN), _kernel(4, 880, 60),               # step.optimizer
            {"cat": "ac2g", "name": "flow", "ts": 1}]


def test_trace_thread_ids():
    assert spans.trace_tids(THREADS) == {0x4D373300: MAIN, MAIN: MAIN, 0xA9FFF6C0: AUTOGRAD,
                                         1442842944: AUTOGRAD, AUTOGRAD: AUTOGRAD}
    assert spans.trace_tids(None) == {}


def test_kernels_go_to_the_span_that_launched_them():
    b = spans.merge(_events(), BASE, SPANS, 1, "train.step", threads=THREADS)
    assert b["clock"]["ok"] and b["clock"]["skew_us"] == 0.0
    assert b["device_self_ms"] == pytest.approx({
        "train.step": 0.01, "step.forward": 0.0, "attn.fwd": 0.04, "step.backward": 0.1,
        "attn.bwd": 0.05, "step.optimizer": 0.06})
    # inclusive: a span counts what falls in the spans inside it, on any thread
    assert b["device_ms"] == pytest.approx({
        "train.step": 0.26, "step.forward": 0.04, "attn.fwd": 0.04, "step.backward": 0.15,
        "attn.bwd": 0.05, "step.optimizer": 0.06})
    assert b["launches"]["step.backward"] == 2 and b["launches"]["train.step"] == 5
    assert b["coverage"]["device"] == pytest.approx(1 - 0.01 / 0.26)
    assert b["coverage"]["launches_on_own_thread"] == pytest.approx(4 / 5)
    assert b["device_ms_total"] == pytest.approx(0.26)
    # without the thread table every launch falls back to the spans open then
    alone = spans.merge(_events(), BASE, SPANS, 1, "train.step")
    assert alone["coverage"]["launches_on_own_thread"] == 0.0


def test_the_launching_thread_comes_first():
    """A kernel launched from the autograd thread while it is in no span goes
    to the main thread's innermost span, not to a span of that thread that
    opens later; one launched from the main thread goes to the main thread's
    span even where a span on the autograd thread opened later."""
    ev = _events() + [_launch(6, 530, MAIN), _kernel(6, 960, 20)]
    b = spans.merge(ev, BASE, SPANS, 1, "train.step", threads=THREADS)
    assert b["device_self_ms"]["step.backward"] == pytest.approx(0.12)
    assert b["device_self_ms"]["attn.bwd"] == pytest.approx(0.05)
    t = spans.merge(ev, BASE, SPANS, 1, "train.step")   # by time alone: the later span
    assert t["device_self_ms"]["attn.bwd"] == pytest.approx(0.07)


def test_idle_gaps_go_to_the_span_open_at_their_middle():
    b = spans.merge(_events(), BASE, SPANS, 2, "train.step")   # two steps: halves
    # gaps: 15-130 (no span), 140-300 (attn.fwd), 340-500, 600-650, 700-880 (step.backward)
    assert b["idle_self_ms"] == pytest.approx({
        "train.step": 0.0, "step.forward": 0.0, "attn.fwd": 0.08, "step.backward": 0.195,
        "attn.bwd": 0.0, "step.optimizer": 0.0})
    assert b["idle_ms"]["step.forward"] == pytest.approx(0.08)
    assert b["idle_ms"]["train.step"] == pytest.approx(0.275)
    assert b["idle_ms_total"] == pytest.approx(0.3325)
    assert b["coverage"]["idle"] == pytest.approx(0.275 / 0.3325)
    assert b["coverage"]["idle_program"] == pytest.approx(0.275 / 0.3325)
    assert b["longest_gaps"][0] == ["step.backward", pytest.approx(0.18)]
    assert ["(none)", pytest.approx(0.115)] in b["longest_gaps"]


def test_idle_in_the_harness_wait_is_told_apart():
    """A gap inside the harness's ``bench.wait`` is in a named span, but not
    in one of the program's; a gap in the root's own time is in neither."""
    late = [_span("bench.wait", 950, 995, 7, 1, MAIN)]
    ev = _events() + [_launch(8, 990, MAIN), _kernel(8, 998, 1)]
    b = spans.merge(ev, BASE, SPANS + late, 1, "train.step", threads=THREADS)
    # the gap 940-998 (middle 969) falls in bench.wait; 15-130 in no span
    assert b["idle_self_ms"]["bench.wait"] == pytest.approx(0.058)
    total = b["idle_ms_total"]
    assert b["coverage"]["idle"] == pytest.approx(1 - 0.115 / total)
    assert b["coverage"]["idle_program"] == pytest.approx(1 - (0.115 + 0.058) / total)


def test_values_of_the_per_layer_numbers():
    rec = {"a": spans.host_summary(SPANS[1:], "train.step", 1), "b": spans.merge(
        _events(), BASE, SPANS, 1, "train.step")}
    rec["a"]["counters"] = {"data.item_slots": 400, "data.valid_items": 100}
    assert spans.value("attn_ms.train", rec) == pytest.approx(0.09)
    assert spans.value("optimizer_device_ms.train", rec) == pytest.approx(0.06)
    assert spans.value("idle_enqueue_ms.train", rec) == pytest.approx(0.16 + 0.39)
    assert spans.value("padded_items.train", rec) == pytest.approx(75.0)
    assert spans.value("enqueue_ms.train", rec) == pytest.approx(0.25 + 0.4 + 0.15)
    assert spans.value("data_ms.train", rec) is None          # no data.* span here
    assert spans.value("enqueue_ms.serve", rec) is None       # no search span


@pytest.mark.parametrize("marker_us, ok", [((30, 60), True), ((40, 60), False), ((0, 20), True)])
def test_the_clock_check(marker_us, ok):
    """The marker must hold the cudaDeviceSynchronize (15-25 us) within 20 us;
    otherwise no device-side number is given."""
    moved = [_span("clock.sync", *marker_us, 9, 0, MAIN)] + SPANS[1:]
    b = spans.merge(_events(), BASE, moved, 1, "train.step")
    assert b["clock"]["ok"] is ok
    assert b["clock"]["skew_us"] == pytest.approx({(30, 60): 15, (40, 60): 25, (0, 20): 5}[marker_us])
    rec = {"a": spans.host_summary(moved[1:], "train.step", 1), "b": b}
    assert (spans.value("attn_ms.train", rec) is None) is not ok
    assert ("device_ms" in b) is ok
    assert spans.value("enqueue_ms.train", rec) is not None   # host numbers stand


def test_no_marker_or_no_sync_refuses():
    assert not spans.merge(_events(), BASE, SPANS[1:], 1, "train.step")["clock"]["ok"]
    no_sync = [e for e in _events() if e["name"] != "cudaDeviceSynchronize"]
    assert not spans.merge(no_sync, BASE, SPANS, 1, "train.step")["clock"]["ok"]


@pytest.mark.parametrize("metric", sorted(spans.METRICS))
def test_values_need_their_fields(metric):
    assert spans.value(metric, {}) is None
    assert spans.value(metric, {"a": {}, "b": {"clock": {"ok": True}}}) is None
    assert spans.value(metric, {"a": {"by_name": {}, "counters": {}},
                                "b": {"clock": {"ok": False}}}) is None


def test_host_summary():
    a = spans.host_summary(SPANS[1:], "train.step", 2)
    by = a["by_name"]
    assert by["train.step"]["total_ms"] == pytest.approx(0.45)
    # 900 us less its children's 250 + 400 + 150
    assert by["train.step"]["self_ms"] == pytest.approx(0.05)
    assert by["step.forward"]["self_ms"] == pytest.approx(0.1)   # less attn.fwd
    assert a["named_share"] == pytest.approx(800 / 900)
    # attn.bwd on its own thread adds its 50 us to the 900 the step's tree sums to
    assert a["self_sum_share"] == pytest.approx(950 / 900)
    assert by["attn.bwd"]["count"] == 1


def test_cover_against_brute_force():
    rng = random.Random(3)
    iv = [(a, a + rng.uniform(0, 30)) for a in (rng.uniform(0, 100) for _ in range(60))]
    ts = [rng.uniform(-5, 135) for _ in range(200)] + [iv[0][0], iv[1][1]]
    got = spans._cover(iv, ts)
    assert got == [sorted(i for i, (a, b) in enumerate(iv) if a <= t <= b) for t in ts]


def test_windows_record_roots_only_when_on():
    from rqvae_tpu_torch.utils import profiling

    def step():
        with profiling.span("data.sample"):
            profiling.count("data.item_slots", 4)

    off = spans.window(step, 3, "train.step", lambda: None, on=False)
    assert off["spans"] == [] and off["counters"] == {} and off["seconds"] > 0
    on = spans.window(step, 3, "train.step", lambda: None, on=True)
    assert [s[0] for s in on["spans"]] == ["train.step", "data.sample"] * 3
    assert on["counters"] == {"data.item_slots": 12} and not profiling.enabled()
    a = spans.host_summary(on["spans"], "train.step", 3)
    assert a["by_name"]["train.step"]["count"] == 3
    assert a["self_sum_share"] == pytest.approx(1.0)
