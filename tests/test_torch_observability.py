"""The port's observability hooks: ``utils/logging.MetricsLogger``'s sinks
(the four tests of ``tests/test_logging.py``, on the port's logger),
``utils/profiling.StepProfiler`` (its window, and a ``profile_dir`` run of
``train_rqvae.train`` that writes a trace of the window and nothing without
it) and ``debug_nans`` (``FloatingPointError`` on a NaN feature, naming the
step; a finite run passes with the same losses as without the option)."""
import io
import json
import math
import os

import numpy as np
import pytest
import torch

from rqvae_tpu_torch.data import registry as treg
from rqvae_tpu_torch.train import train_decoder as ttd
from rqvae_tpu_torch.train import train_rqvae as ttr
from rqvae_tpu_torch.utils import profiling
from rqvae_tpu_torch.utils.logging import MetricsLogger

from test_torch_train_rqvae import CaptureLogger, _train_cfg


def test_jsonl_default(tmp_path):
    p = tmp_path / "m.jsonl"
    lg = MetricsLogger(path=str(p), every=2)
    lg.log(2, {"loss": 1.5})
    lg.log(3, {"loss": 9.0})   # skipped (every=2)
    lg.log(3, {"loss": 2.5}, force=True)
    lg.close()
    recs = [json.loads(x) for x in p.read_text().splitlines()]
    assert [r["loss"] for r in recs] == [1.5, 2.5]
    assert recs[0]["step"] == 2


def test_tensorboard_sink_writes_event_file(tmp_path):
    tb = tmp_path / "tb"
    lg = MetricsLogger(stream=io.StringIO(), sink="tensorboard", tensorboard_dir=str(tb))
    lg.log(1, {"loss": 1.0, "note": "a-string"})
    lg.log(2, {"loss": 0.5})
    lg.close()
    assert any(f.startswith("events.out.tfevents") for f in os.listdir(tb))
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(tb))
    acc.Reload()
    assert [(v.step, v.value) for v in acc.Scalars("loss")] == [(1, 1.0), (2, 0.5)]


def test_tensorboard_dir_defaults_next_to_jsonl(tmp_path):
    p = tmp_path / "logs" / "m.jsonl"
    os.makedirs(p.parent)
    lg = MetricsLogger(path=str(p), sink="tensorboard")
    lg.log(1, {"x": 1.0})
    lg.close()
    assert os.path.isdir(tmp_path / "logs" / "tb")
    assert json.loads(p.read_text())["x"] == 1.0


def test_unknown_sink_rejected():
    with pytest.raises(ValueError, match="swanlab"):
        MetricsLogger(sink="swanlab")


class _FakeProfile:
    log = []

    def __init__(self, activities, on_trace_ready):
        self.activities = activities

    def start(self):
        self.log.append(("start", self.activities))

    def stop(self):
        self.log.append(("stop",))


def test_step_profiler_window(monkeypatch, tmp_path):
    import torch.profiler

    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    _FakeProfile.log = []
    prof = profiling.StepProfiler(str(tmp_path), start=2, num_steps=3, device="cpu")
    seen = []
    for it in range(8):
        prof.step(it)
        seen.append(len(_FakeProfile.log))
    assert seen == [0, 0, 1, 1, 1, 2, 2, 2]       # starts at 2, stops at 5
    assert _FakeProfile.log[0] == ("start", [torch.profiler.ProfilerActivity.CPU])
    # close() stops a trace that is still running, and only then
    prof = profiling.StepProfiler(str(tmp_path), start=0, num_steps=10, device="cpu")
    prof.step(0)
    prof.close()
    prof.close()
    assert _FakeProfile.log[-2:] == [("start", [torch.profiler.ProfilerActivity.CPU]), ("stop",)]
    # no trace_dir: nothing happens
    _FakeProfile.log = []
    prof = profiling.StepProfiler(None, start=0, num_steps=1)
    for it in range(3):
        prof.step(it)
    prof.close()
    assert _FakeProfile.log == []


def test_profile_dir_run_writes_a_trace_of_the_window(tmp_path):
    trace_dir = tmp_path / "trace"
    ttr.train(_train_cfg(tmp_path, 1, iterations=6, profile_dir=str(trace_dir),
                         profile_start=2, profile_steps=2), logger=CaptureLogger(), device="cpu")
    files = list(trace_dir.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::mm" in names or "aten::addmm" in names
    # two steps: AdamW's foreach update ran twice in the window
    assert sum(e.get("name") == "aten::_foreach_add_" for e in events) >= 2
    # the window's program spans, on the trace's clock: two train.step roots,
    # each holding its forward, backward and optimizer in time on its thread
    spans = [e for e in events if e.get("cat") == "program_span"]
    roots = [e for e in spans if e["name"] == "train.step"]
    assert [e["args"]["step"] for e in roots] == [2, 3]
    for root in roots:
        inner = [e for e in spans if e["args"]["request_id"] == root["args"]["span_id"]
                 and e is not root]
        assert [e["name"] for e in inner if e["name"].startswith("step.")] == [
            "step.forward", "step.backward", "step.optimizer"]
        for e in inner:
            assert e["tid"] == root["tid"]
            assert root["ts"] <= e["ts"] and e["ts"] + e["dur"] <= root["ts"] + root["dur"]
    ops = [e for e in events if e.get("cat") == "cpu_op" and e["name"] == "aten::_foreach_add_"]
    assert any(root["ts"] <= e["ts"] <= root["ts"] + root["dur"] for e in ops for root in roots)
    assert not profiling.enabled() and profiling.collect()["spans"] == []


def test_no_profile_dir_writes_nothing(tmp_path, monkeypatch):
    import torch.profiler

    monkeypatch.setattr(torch.profiler, "profile", lambda *a, **k: pytest.fail("traced"))
    ttr.train(_train_cfg(tmp_path, 1, iterations=4), logger=CaptureLogger(), device="cpu")
    assert sorted(os.listdir(tmp_path)) == ["ck"]


def _nan_items(monkeypatch):
    real = treg.load

    def load(*args, **kwargs):
        bundle = real(*args, **kwargs)
        bundle.items.x[::4, 5] = np.nan   # a NaN in most batches of 16
        return bundle

    monkeypatch.setattr(treg, "load", load)


def test_debug_nans_raises_on_a_nan_feature(tmp_path, monkeypatch):
    _nan_items(monkeypatch)
    cfg = _train_cfg(tmp_path, 1, iterations=12, use_kmeans_init=False, debug_nans=True)
    with pytest.raises(FloatingPointError, match=r"step \d+: "):
        ttr.train(cfg, logger=CaptureLogger(), device="cpu")
    # without the option the NaN goes through unnoticed
    log = CaptureLogger()
    ttr.train(_train_cfg(tmp_path / "off", 1, iterations=12, use_kmeans_init=False),
              logger=log, device="cpu")
    assert any(math.isnan(float(r["total_loss"])) for r in log.records if "total_loss" in r)


@pytest.mark.parametrize("spc", [1, 4])
def test_debug_nans_passes_a_finite_run_unchanged(tmp_path, spc):
    logs = []
    for flag in (False, True):
        log = CaptureLogger()
        ttr.train(_train_cfg(tmp_path / str(flag), spc, iterations=8, debug_nans=flag),
                  logger=log, device="cpu")
        logs.append([float(r["total_loss"]) for r in log.records if "total_loss" in r])
    assert logs[0] == logs[1] and all(math.isfinite(x) for x in logs[0])


def test_check_finite_names_the_first_bad_leaf():
    grads = {"a": torch.ones(3), "b": [torch.ones(2), torch.tensor([1.0, float("inf")])]}
    with pytest.raises(FloatingPointError, match="gradient b/1"):
        ttd.check_finite(grads, torch.tensor(1.0))
    with pytest.raises(FloatingPointError, match="loss"):
        ttd.check_finite(grads, torch.tensor(float("nan")))
    ttd.check_finite({"a": torch.ones(3)}, torch.tensor(1.0))
    ttd.check_finite({"a": torch.ones(3)})
