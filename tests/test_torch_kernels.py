"""The PyTorch port's two kernels against the JAX package's Pallas kernels,
plus the port's import isolation and device policy.

On the CPU each wrapper runs its plain PyTorch twin (the CUDA kernels build
and run on the GPU only; ``chip_smoke.py`` compares them with these twins
there). The Pallas kernels run in interpret mode, as the JAX package's own
tests run them on the CPU.
"""
import ast
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.ops import quantize_pallas
from rqvae_tpu.ops.children_window import children_window as jax_children_window
from rqvae_tpu_torch.models import retrieval, rqvae
from rqvae_tpu_torch.models import convert
from rqvae_tpu_torch.ops.children_window import children_window
from rqvae_tpu_torch.ops.quantize_kernels import rq_tokenize

REPO = pathlib.Path(__file__).resolve().parent.parent


def near_tie_rows(x, codebooks, ids, rel=1e-5):
    """Rows where, at some level along the ``ids`` residual chain, the two
    smallest distances (float64) differ by less than ``rel`` relative: there
    fp32 sums taken in another order may pick either code."""
    res = x.astype(np.float64)
    near = np.zeros(x.shape[0], bool)
    for level, cb in enumerate(codebooks.astype(np.float64)):
        dist = ((res[:, None, :] - cb[None]) ** 2).sum(-1)
        two = np.sort(dist, axis=1)[:, :2]
        near |= (two[:, 1] - two[:, 0]) < rel * np.maximum(1.0, np.abs(two[:, 0]))
        res = res - cb[ids[:, level]]
    return near


@pytest.mark.parametrize("b,d,k,l", [(64, 32, 256, 3), (37, 16, 32, 2)])
def test_rq_tokenize_plain_matches_pallas(b, d, k, l):
    rng = np.random.RandomState(0)
    x = rng.randn(b, d).astype(np.float32)
    cbs = rng.randn(l, k, d).astype(np.float32)
    want = quantize_pallas.rq_tokenize(jnp.asarray(x), jnp.asarray(cbs), commitment_weight=0.25,
                                       block_b=32, interpret=True)
    got = rq_tokenize(torch.from_numpy(x), torch.from_numpy(cbs), commitment_weight=0.25)
    wid, gid = np.asarray(want.sem_ids), got.sem_ids.numpy()
    differ = (wid != gid).any(axis=1)
    near = near_tie_rows(x, cbs, wid)
    assert not (differ & ~near).any(), f"ids differ off near-ties: rows {np.nonzero(differ & ~near)}"
    print(f"rq_tokenize {b}x{d}x{k}x{l}: {int(differ.sum())} id rows differ, {int(near.sum())} near-tie rows")
    same = ~differ
    for name in ("emb_sum", "residual", "loss"):
        np.testing.assert_allclose(getattr(got, name).numpy()[same],
                                   np.asarray(getattr(want, name))[same],
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_rq_tokenize_rejects_mismatched_shapes():
    with pytest.raises(ValueError):
        rq_tokenize(torch.zeros(4, 8), torch.zeros(2, 16, 4))


def test_children_window_plain_matches_pallas():
    """Same per-row child tokens as the Pallas kernel (interpret mode), as a
    multiset and as the validity mask the beam search builds from it."""
    rng = np.random.RandomState(11)
    n, r, k = 500, 70, 32
    table = np.sort(rng.choice(2**20, n, replace=False)).astype(np.uint32)
    lo = rng.randint(0, n, r).astype(np.int32)
    cnt = np.minimum(rng.randint(0, k + 5, r), n - lo).astype(np.int32)  # runs end inside the table
    key0 = (table[lo] // 7 * 7).astype(np.uint32)
    want = np.asarray(jax_children_window(
        jnp.asarray(table), jnp.asarray(lo), jnp.asarray(cnt), jnp.asarray(key0),
        window=k, k_tokens=k, block_r=16, interpret=True))
    got = children_window(torch.from_numpy(table.astype(np.int64)), torch.from_numpy(lo),
                          torch.from_numpy(cnt), torch.from_numpy(key0.astype(np.int64)),
                          window=k, k_tokens=k).numpy()
    assert got.shape == (r, k) and got.dtype == np.int32
    for i in range(r):
        np.testing.assert_array_equal(np.sort(got[i][got[i] < k]), np.sort(want[i][want[i] < k]))
    mask = lambda c: (np.eye(k + 1, dtype=bool)[c].any(axis=1))[:, :k]  # noqa: E731
    np.testing.assert_array_equal(mask(got), mask(want))
    assert (mask(got).sum(1) > 0).any()


def test_kernel_wrappers_refuse_other_devices():
    """A tensor neither on the CPU (plain twin) nor on CUDA (kernel) raises."""
    meta = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError):
        rq_tokenize(meta, torch.empty((2, 16, 8), device="meta"))
    i32 = dict(dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        children_window(torch.empty(10, dtype=torch.int64, device="meta"), torch.empty(3, **i32),
                        torch.empty(3, **i32), torch.empty(3, dtype=torch.int64, device="meta"),
                        window=4, k_tokens=4)


@pytest.mark.parametrize("entry", ["rqvae.init", "retrieval.init", "convert.from_numpy"])
def test_entry_points_need_cuda_unless_cpu_requested(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "rqvae.init": lambda **kw: rqvae.init(torch.Generator(), rqvae.RqVaeConfig(), **kw),
        "retrieval.init": lambda **kw: retrieval.init(
            torch.Generator(), retrieval.RetrievalConfig(n_layers=2, attn_dim=32, num_heads=2,
                                                         mlp_hidden_dim=32), **kw),
        "convert.from_numpy": lambda **kw: convert.from_numpy({"w": np.ones(3, np.float32)}, **kw),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
    assert isinstance(calls[entry](device="cpu"), dict)


def _port_sources():
    return sorted((REPO / "rqvae_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "rqvae_tpu"), f"{path.name} imports {name}"


def test_port_import_loads_no_jax():
    """Importing every port module in a fresh interpreter pulls in no JAX."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "rqvae_tpu_torch").rglob("*.py") if p.name != "__init__.py"
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'rqvae_tpu'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
