"""Data parallelism over ``torch.distributed`` (the data-parallel half of
rqvae_tpu/parallel/mesh.py).

The reference's only distribution strategy is DDP (HF Accelerate: an NCCL
all-reduce of the gradients, ``split_batches``). The port runs it as the
reference does: one process a GPU (``torchrun --nproc_per_node=N``), each
process holding a full replica of the parameters and the optimizer state and
feeding its own block of every global batch; gradients are all-reduced once
a step over one flat buffer.

* ``maybe_init_distributed`` joins the process group that ``torchrun``'s
  variables describe (NCCL for CUDA, gloo for the CPU); without them it does
  nothing, and the loops run on one device with no collective.
* ``make_mesh`` checks the (data, model) shape against the world size and
  registers the mesh with ``ops/dispatch``; a model axis above 1 (tensor
  parallelism) raises ``NotImplementedError``.
* The collectives (``all_reduce_``, ``broadcast_``, ``barrier``) act only
  while a mesh with a data axis above 1 is registered: with no group, a world
  of one, or inside ``dispatch.local_execution``, they return at once, with
  no collective and no host sync. ``collective_calls`` counts the
  collectives issued.

No counterpart: ``shard_batch``, ``batch_sharding``, ``replicated``,
``replicate_host_array`` and ``dp_param_shardings``: each process holds its
own rows, so there is no global array to assemble or place. Replicas stay
equal because rank 0's parameters are broadcast once after ``init`` /
restore and again after ``kmeans_prime`` (whose ``index_add_`` sums in a
non-deterministic order on the card), and every rank applies the same
all-reduced gradients. The tensor-parallel rules (``tp_param_shardings``,
``rqvae_tp_param_shardings``, ``opt_state_shardings``) are not ported.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from rqvae_tpu_torch.ops import dispatch
from rqvae_tpu_torch.utils.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")

collective_calls = 0   # collectives issued by this module, reset by the caller


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, model) process mesh: ``data`` replicas, ``model`` = 1."""
    data: int
    model: int = 1

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def maybe_init_distributed(device=None, backend: Optional[str] = None) -> int:
    """Join the process group ``torchrun``'s ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` describe: NCCL when
    ``device`` (``resolve_device``'s default: ``cuda:$LOCAL_RANK``) is CUDA,
    gloo for the CPU, unless ``backend`` names one. A CUDA device with an
    index becomes the process's current device. Idempotent; does nothing when the
    variables are unset. Returns the world size."""
    if dist.is_initialized():
        return dist.get_world_size()
    if any(os.environ.get(k) is None for k in TORCHRUN_ENV):
        return 1
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]))
    return dist.get_world_size()


def process_local_batch_size(global_batch: int) -> int:
    """``split_batches``: the configured batch is global; each process feeds
    its 1 / world share."""
    n = world_size()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} processes")
    return global_batch // n


def host_block(global_idx: np.ndarray, local_rows: int) -> np.ndarray:
    """This process's contiguous block of a global batch's row indices: rank
    r feeds rows [r * local_rows, (r + 1) * local_rows)."""
    r = rank()
    return global_idx[r * local_rows:(r + 1) * local_rows]


def refuse_tensor_parallel(mesh_shape: Optional[Sequence[int]], tensor_parallel: bool) -> None:
    """The entry points' one refusal: tensor parallelism, asked for by
    ``tensor_parallel=True`` or a ``mesh_shape`` whose model axis is above 1."""
    if tensor_parallel:
        raise NotImplementedError("tensor_parallel=True is not ported: the port runs data "
                                  "parallelism only")
    if mesh_shape is not None and len(mesh_shape) > 1 and int(mesh_shape[1]) > 1:
        raise NotImplementedError(f"mesh_shape {tuple(mesh_shape)}: a model axis above 1 "
                                  "(tensor_parallel) is not ported")


def make_mesh(shape: Optional[Sequence[int]] = None) -> Mesh:
    """The (data, model) mesh over the world's processes, registered with
    ``ops/dispatch``. Default (world, 1); the product must equal the world
    size; a model axis above 1 raises (tensor parallelism is not ported)."""
    n = world_size()
    shape = tuple(int(s) for s in (shape if shape is not None else (n, 1)))
    if len(shape) != 2 or int(np.prod(shape)) != n:
        raise ValueError(f"mesh_shape {shape} does not cover the {n} processes as (data, model)")
    refuse_tensor_parallel(shape, False)
    mesh = Mesh(data=shape[0], model=shape[1])
    dispatch.set_execution_mesh(mesh)
    return mesh


def data_parallel() -> bool:
    """Whether the collectives act: a registered mesh with a data axis above
    1, outside ``dispatch.local_execution``."""
    mesh = dispatch.execution_mesh()
    return mesh is not None and mesh.data > 1 and world_size() > 1


def _count() -> None:
    global collective_calls
    collective_calls += 1


def _flat(tensors: List[torch.Tensor]) -> torch.Tensor:
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise ValueError(f"one flat buffer needs one dtype, got {sorted(map(str, dtypes))}")
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat_(tensors: List[torch.Tensor], flat: torch.Tensor) -> None:
    parts = flat.split([t.numel() for t in tensors])
    torch._foreach_copy_(tensors, [p.view_as(t) for p, t in zip(parts, tensors)])


def all_reduce_(tensors: List[torch.Tensor], op: str = "mean") -> List[torch.Tensor]:
    """Sum (``op="sum"``) or mean (``"mean"``) ``tensors`` over the data
    replicas in place, in one ``all_reduce`` over a flat buffer; an identity
    when no data mesh is active. Returns ``tensors``."""
    if op not in ("sum", "mean"):
        raise ValueError(f"unknown reduction {op!r}")
    if not tensors or not data_parallel():
        return tensors
    flat = _flat(tensors)
    _count()
    dist.all_reduce(flat)
    if op == "mean":
        flat.div_(world_size())
    _unflat_(tensors, flat)
    return tensors


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """A reduced copy of ``t`` (``t`` itself when no data mesh is active)."""
    if not data_parallel():
        return t
    return all_reduce_([t.clone()], "sum")[0]


def broadcast_(tensors: List[torch.Tensor], src: int = 0) -> List[torch.Tensor]:
    """Overwrite ``tensors`` with rank ``src``'s, in one broadcast over a
    flat buffer per dtype; an identity when no data mesh is active."""
    if not tensors or not data_parallel():
        return tensors
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = _flat(group)
        _count()
        dist.broadcast(flat, src)
        _unflat_(group, flat)
    return tensors


def barrier() -> None:
    """Wait for every replica; an identity when no data mesh is active."""
    if data_parallel():
        _count()
        dist.barrier()


def fetch_to_host(tree):
    """Host copy of a device tree. Data-parallel replicas are whole on every
    rank, so no gather is needed (JAX's gathers tensor-parallel shards)."""
    from rqvae_tpu_torch.utils.tree import tree_map

    return tree_map(lambda t: t.detach().cpu() if isinstance(t, torch.Tensor) else t, tree)
