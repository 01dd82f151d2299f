"""A run with the timed path broken underneath comes out not correct: for
each fault the cell can have, planted in the port, a whole run of the cell
through ``run.main`` (the look for a card skipped, a tiny size on the CPU).
A card test holds the control (the reference in TF32 in the program's
place) against the cell's limits at the cell's own size."""
import pytest
import torch

from portbench import judge, readings, spec
from portbench.conftest import bench_with_kept

BENCH = bench_with_kept()
TRAIN = [w["name"] for w in BENCH["workloads"] if spec.traffic(w["traffic"])["kind"] == "train"]
SERVE = [w["name"] for w in BENCH["workloads"] if spec.traffic(w["traffic"])["kind"] == "serve"]


@pytest.mark.parametrize("fault", ["half_batch", "unchanged_state"])
@pytest.mark.parametrize("cell", TRAIN)
def test_train_fault_fails(cell, fault, run_tiny):
    with readings.fault("train", fault):
        rc, result = run_tiny(cell)
    assert rc == 0 and result["correct"] is False, result["checks"]


@pytest.mark.parametrize("cell", SERVE)
def test_serve_fault_fails(cell, run_tiny):
    with readings.fault("serve", "altered_token"):
        rc, result = run_tiny(cell)
    assert rc == 0 and result["correct"] is False, result["checks"]


@pytest.mark.card
@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_control_fails_on_card(cell, card):
    import argparse

    from portbench import device as device_lib
    from portbench import run

    ns = argparse.Namespace(workload=cell, seed=2**31 + 4242, seconds=1.0, trace=0)
    ctx = run.context(ns, BENCH, card, device_lib.process_seconds)
    ctx.traffic.update(warmup_steps=0, warmup_calls=0)
    kind = ctx.traffic["kind"]
    reading = readings.train_reading if kind == "train" else readings.serve_reading
    with pytest.MonkeyPatch.context() as mp:
        for key, value in ctx.config.get("env", {}).items():
            mp.setenv(key, str(value))
        ok, checks = judge.verdict(reading(ctx, "control"), spec.limits(cell))
    assert not ok, checks
    torch.cuda.empty_cache()
