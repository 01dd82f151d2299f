"""Device time of the port's ``rq_tokenize`` kernel at the Amazon corpus
shape (4,096-row chunks, 3 x 256 x 32 fp32 codebooks), for comparing two
checkouts of the repository on one GPU.

It uses only ``ops/_cuda_build.build_all`` and
``ops/quantize_kernels.rq_tokenize``, which every version of the port has,
and imports the package of the checkout it sits in. Prints one JSON line:
the device microseconds per launch of each kernel the call runs
(torch.profiler over 50 calls) and the CUDA-event milliseconds per call.
Run from a checkout's root: ``python3 experiments/torch_rq_tokenize_ab.py``.
"""
import json
import pathlib
import sys

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from rqvae_tpu_torch.ops import _cuda_build  # noqa: E402
from rqvae_tpu_torch.ops.quantize_kernels import rq_tokenize  # noqa: E402


def main() -> int:
    _cuda_build.build_all(["rq_tokenize"])
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(4096, 32, device=dev, generator=g)
    cbs = torch.randn(3, 256, 32, device=dev, generator=g) * 0.7
    for _ in range(5):
        rq_tokenize(x, cbs)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(50):
        rq_tokenize(x, cbs)
    end.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(50):
            rq_tokenize(x, cbs)
        torch.cuda.synchronize()
    device_us = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            total = getattr(e, "self_device_time_total", 0) or e.self_cuda_time_total
            device_us[e.key[:60]] = total / e.count
    print(json.dumps({"tree": str(pathlib.Path(__file__).resolve().parent.parent),
                      "event_ms_per_call": start.elapsed_time(end) / 50,
                      "device_us_per_launch": device_us}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
