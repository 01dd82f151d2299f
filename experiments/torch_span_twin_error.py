"""Worst error of the span twins against the Pallas span kernel, repeated.

``tests/test_torch_packing.py::test_span_twins_match_jax_kernel`` holds
``flash_attention_spans_plain`` (values, 2e-5) and its backward twin and
autograd (gradients, 1e-4) against ``rqvae_tpu``'s span kernel in interpret
mode. This script reruns the test's three cases (Nq x Nk = 70 x 70, 70 x 100,
130 x 67, the test's own seeds) ``--repeats`` times under each torch
intra-op thread count in ``--threads``, in ``--procs`` processes at once
(the tier-1 run has six xdist workers), and prints one JSON line per process
with the worst absolute error of the values and of the gradients and each
beside its bound, so a sum-order effect would show as errors that move with
the thread count or the load.

    JAX_PLATFORMS=cpu python experiments/torch_span_twin_error.py --procs 6
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = ((70, 70), (70, 100), (130, 67))


def worst_errors(threads, repeats):
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import conftest  # noqa: F401  (the tests' XLA flags: 8 host devices)
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from rqvae_tpu.ops import flash_attention as jfa
    from rqvae_tpu_torch.ops import flash_attention as tfa
    from test_torch_packing import _spans

    out = {}
    for n_threads in threads:
        torch.set_num_threads(n_threads)
        worst = {"values": 0.0, "grads": 0.0}
        for _ in range(repeats):
            for nq, nk in CASES:
                rng = np.random.RandomState(0)
                b, h, dh = 2, 2, 64
                q, k, v = (rng.randn(b, h, n, dh).astype(np.float32) for n in (nq, nk, nk))
                spans = _spans(rng, b, nq, nk)
                g = rng.randn(b, h, nq, dh).astype(np.float32)
                jspans = tuple(map(jnp.asarray, spans))

                def jflash(q_, k_, v_):
                    return jfa.flash_attention_spans(q_, k_, v_, *jspans, interpret=True)

                jq, jk, jv = map(jnp.asarray, (q, k, v))
                want = np.asarray(jflash(jq, jk, jv))
                want_grads = jax.grad(lambda *a: (jflash(*a) * jnp.asarray(g)).sum(),
                                      argnums=(0, 1, 2))(jq, jk, jv)
                tspans = tuple(map(torch.from_numpy, spans))
                tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
                got = tfa.flash_attention_spans_plain(tq, tk, tv, *tspans)
                grads = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(g))
                twin = tfa.flash_attention_spans_bwd_plain(tq.detach(), tk.detach(), tv.detach(),
                                                           *tspans, torch.from_numpy(g))
                worst["values"] = max(worst["values"], float(np.abs(got.detach().numpy() - want).max()))
                for a, b_ in zip(grads + twin, tuple(want_grads) * 2):
                    worst["grads"] = max(worst["grads"], float(np.abs(a.numpy() - np.asarray(b_)).max()))
        out[str(n_threads)] = worst
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--threads", default="1,3,8", help="torch intra-op thread counts")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--procs", type=int, default=1, help="processes at once")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    threads = [int(t) for t in args.threads.split(",")]
    if args.worker or args.procs == 1:
        print(json.dumps({"pid": os.getpid(), "bounds": {"values": 2e-5, "grads": 1e-4},
                          "worst_abs_err_by_threads": worst_errors(threads, args.repeats)}),
              flush=True)
        return 0
    cmd = [sys.executable, __file__, "--worker", "--threads", args.threads,
           "--repeats", str(args.repeats)]
    procs = [subprocess.Popen(cmd) for _ in range(args.procs)]
    return max(p.wait() for p in procs)


if __name__ == "__main__":
    sys.exit(main())
