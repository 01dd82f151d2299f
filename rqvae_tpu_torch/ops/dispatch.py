"""The kernel switch and the mesh registry (counterpart of
rqvae_tpu/ops/dispatch.py).

``kernels_enabled()`` reads ``RQVAE_TPU_DISABLE_PALLAS`` at each call, the
JAX package's own variable, so one environment routes both packages the same
way. Unset (or not ``"1"``), every kernel route of the port stays as it is:
the CUDA kernels for CUDA tensors, their plain twins for CPU tensors. Set to
``"1"``, every route point takes the route JAX takes with the same variable
set, on the CPU and on CUDA alike, and no kernel and no twin is called:

* ``ops/attention.attend``: the dense ``sdpa`` at every shape, under the
  span, key and causal masks ``build_mask`` builds;
* ``models/rqvae.get_semantic_ids`` (training): the plain per-level loop;
* ``models/rqvae.encode_and_tokenize``: ``get_semantic_ids(...).sem_ids``;
* ``tokenizer/semids.children_mask``: the window gather and the fold of the
  child tokens into the (R, K) mask, in plain torch ops.

The switch is explicit and read where the route is taken, so a process can
time a step on both routes in turns; it is never a quiet fallback.

The mesh registry holds the (data, model) mesh that
``parallel/mesh.make_mesh`` registers. ``model_axis_size`` reads it: the
number of shards the parameters are split into, which the models divide
their heads, codebook rows and MLP widths by (``parallel/tensor``).
``local_execution`` clears it for a process-local computation on whole
parameters (rank 0's diversity metrics, corpus tokenization, k-means
priming): inside it every collective of ``parallel/mesh`` and
``parallel/tensor`` is an identity.

No counterpart:
* ``shard_over_batch``: the port runs one process per GPU, so a kernel only
  ever sees its own rank's rows and, under tensor parallelism, its own
  heads (the column-parallel projections hand it H / m of them): no wrapper;
* ``RQVAE_TPU_FORCE_PALLAS``: the port's kernels run only on the card, and on
  the CPU the port already runs the kernels' twins.
"""
from __future__ import annotations

import contextlib
import os

DISABLE_ENV = "RQVAE_TPU_DISABLE_PALLAS"

_EXECUTION_MESH = None


def kernels_enabled() -> bool:
    """False when ``RQVAE_TPU_DISABLE_PALLAS`` is ``"1"``: every route point
    then takes JAX's plain route."""
    return os.environ.get(DISABLE_ENV, "0") != "1"


def set_execution_mesh(mesh) -> None:
    """Register (or clear, with None) the mesh."""
    global _EXECUTION_MESH
    _EXECUTION_MESH = mesh


def execution_mesh():
    return _EXECUTION_MESH


@contextlib.contextmanager
def local_execution():
    """Clear the registered mesh for a process-local computation on whole
    parameters; every collective is an identity inside."""
    global _EXECUTION_MESH
    saved = _EXECUTION_MESH
    _EXECUTION_MESH = None
    try:
        yield
    finally:
        _EXECUTION_MESH = saved


def divisible_over_data(n: int, heads=None) -> bool:
    """Whether a row count (and a head count over the model axis) divides the
    registered mesh; True with no mesh or a one-device mesh."""
    mesh = _EXECUTION_MESH
    if mesh is None or mesh.size == 1:
        return True
    if n % mesh.data != 0:
        return False
    return heads is None or heads % model_axis_size() == 0


def model_axis_size() -> int:
    """The shards the registered mesh splits the parameters into: its model
    axis under ``tensor_parallel``, else 1 (1 with no mesh)."""
    mesh = _EXECUTION_MESH
    return mesh.tp if mesh is not None else 1
