"""The decoder-only retriever's cell (``dsv2lite_serve``): it runs correct
through ``run.main`` at a tiny size on the CPU; each fault its limits were
set against (``readings_lm.FAULTS``), planted in the port, fails the
check; its reference loads nothing of the port and its kind no JAX. A card
test holds the control (the reference on fp8 round-tripped weights in the
program's place) against the cell's limits at the cell's own size."""
import subprocess
import sys

import pytest

from portbench import judge, readings_lm, spec

CELL = "dsv2lite_serve"


def test_cell_runs_correct(run_tiny):
    rc, result = run_tiny(CELL)
    assert rc == 0 and result["correct"] is True, result and result["checks"]
    assert set(result["metrics"]) == {"queries_per_s", "search_p95_ms", "setup_s"}
    assert set(result["checks"]) == set(spec.limits(CELL))


@pytest.mark.parametrize("fault", readings_lm.FAULTS)
def test_fault_fails(fault, run_tiny):
    with readings_lm.fault(fault):
        rc, result = run_tiny(CELL)
    assert rc == 0 and result["correct"] is False, result["checks"]


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, cwd=spec.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_reference_loads_nothing_of_the_port():
    assert not _loaded("import portbench.reference.lm") & {"rqvae_tpu_torch", "rqvae_tpu", "jax",
                                                           "jaxlib", "flax"}


def test_kind_loads_no_jax():
    code = ("import portbench.kinds.serve_lm, portbench.counts_lm, portbench.readings_lm\n"
            "from portbench import spec\n"
            "for m in ('mla_device_ms.serve', 'moe_device_ms.serve', 'moe_roofline.serve'):\n"
            "    spec.reader(m)\n"
            "import rqvae_tpu_torch.models.generation")
    loaded = _loaded(code)
    assert "rqvae_tpu_torch" in loaded and not loaded & {"jax", "jaxlib", "flax", "rqvae_tpu"}


@pytest.mark.card
def test_control_fails_on_card(card):
    import argparse

    from portbench import device as device_lib
    from portbench import run

    bench = spec.benchmark()
    ns = argparse.Namespace(workload=CELL, seed=2**31 + 4242, seconds=1.0, trace=0)
    ctx = run.context(ns, bench, card, device_lib.process_seconds)
    ctx.traffic["warmup_calls"] = 0
    nums = readings_lm.reading(ctx, "control")
    ok, checks = judge.verdict(nums, spec.limits(CELL))
    assert not ok, checks
