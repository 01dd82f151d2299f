"""The trace reduction on a made-up trace: busy time as the union of the
device intervals, idle gaps labelled by the runtime call the host was in."""
import pytest

from portbench import trace


def test_reduce():
    ev = [{"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 0, "dur": 4},
          {"cat": "kernel", "name": "void flash::small_fwd_tf32_kernel<1>()", "ts": 10, "dur": 20},
          {"cat": "kernel", "name": "gemm", "ts": 25, "dur": 10},
          {"cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 36, "dur": 20},
          {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 60, "dur": 5},
          {"cat": "ac2g", "name": "flow", "ts": 1}]
    tr = trace.reduce(ev, window_s=70e-6)
    assert tr.busy_s == pytest.approx(30e-6)
    assert tr.gaps == [("cudaMemcpyAsync", pytest.approx(25e-6)), ("host", pytest.approx(10e-6))]
    b = trace.breakdown(tr)
    assert b["device_ops"][0][0].startswith("void flash::small")
    assert len(tr.kernels) == 3


def test_reduce_needs_device_work():
    with pytest.raises(RuntimeError):
        trace.reduce([{"cat": "cuda_runtime", "name": "x", "ts": 0, "dur": 1}], 1.0)
