"""Data and tensor parallelism over ``torch.distributed`` (counterpart of
rqvae_tpu/parallel/mesh.py).

The processes form a (data, model) mesh, one process a GPU (``torchrun
--nproc_per_node=N``): rank r sits at (r // model, r % model), as JAX's
``np.asarray(devices).reshape(shape)`` lays devices out. Along ``data`` the
ranks are replicas that feed their own block of every global batch
(``split_batches``) and all-reduce their gradients once a step over one flat
buffer, as the reference's DDP does. Along ``model`` (``tensor_parallel``)
the ranks of a group split every large matrix by JAX's Megatron rules
(``retrieval_tp_spec`` / ``rqvae_tp_spec``, the port's copies of
``_retrieval_tp_spec`` / ``_rqvae_tp_spec``) and meet in the collectives of
``parallel/tensor`` inside the models; the kernels see each rank's own heads.

* ``maybe_init_distributed`` joins the process group that ``torchrun``'s
  variables describe (NCCL for CUDA, gloo for the CPU); without them it does
  nothing, and the loops run on one device with no collective.
* ``make_mesh(shape, tensor_parallel)`` checks the (data, model) shape
  against the world size, creates the data and model process groups (every
  rank creates every group, in one order) and registers the mesh with
  ``ops/dispatch``. Without ``tensor_parallel`` a model axis above 1 holds
  replicas that compute the same rows (JAX's ``dp_param_shardings`` on such a
  mesh); with it and a model axis of 1 the run is data-parallel.
* The data collectives (``all_reduce_``, ``all_reduce_sum``) act over the
  rank's data group while a mesh with a data axis above 1 is registered;
  ``broadcast_`` and ``barrier`` act over the world while a mesh of more than
  one rank is; inside ``dispatch.local_execution`` all return at once, with
  no collective and no host sync. ``collective_calls`` counts them.
* ``shard_params`` / ``gather_params`` carve a whole tree into the rank's
  shards and back, exactly (``shard_state`` / ``gather_state`` do the same
  for ``{"params", "opt_state"}``, the Adam moments following their params
  as JAX's ``opt_state_shardings`` makes them). ``wqkv`` and ``wkv``, whose
  columns are [q | k | v] and [k | v], are carved by heads: each rank takes
  its columns of every block (JAX shards the same dimension contiguously,
  which GSPMD may; an explicit rank needs whole heads). A retrieval model
  whose heads do not divide over the model axis keeps its attention leaves
  whole on every rank (``leaf_spec``); every function that carves or gathers
  the retrieval tree takes its ``heads`` for that.

No counterpart: ``shard_batch``, ``batch_sharding``, ``replicated`` and
``replicate_host_array``: each process holds its own rows, so there is no
global array to assemble or place. Replicas stay equal because rank 0's
whole parameters are broadcast once after ``init`` / restore and again after
``kmeans_prime`` (whose ``index_add_`` sums in a non-deterministic order on
the card), before they are sharded, and every rank applies the same
all-reduced gradients.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from rqvae_tpu_torch.ops import dispatch
from rqvae_tpu_torch.utils.device import resolve_device
from rqvae_tpu_torch.utils.tree import tree_leaves_with_path, tree_map, tree_unflatten

DATA_AXIS = "data"
MODEL_AXIS = "model"
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")

collective_calls = 0   # collectives issued by this module, reset by the caller

_GROUPS = {}   # (data, model) -> (data groups, model groups), made once a shape


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, model) process mesh and this rank's place on it. ``tp`` is
    the number of shards the parameters are split into: ``model`` under
    ``tensor_parallel``, else 1. A group of None is the world."""
    data: int
    model: int = 1
    tensor_parallel: bool = False
    rank: int = 0
    data_group: object = None
    model_group: object = None

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def tp(self) -> int:
        return self.model if self.tensor_parallel else 1


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


def _registered() -> Optional[Mesh]:
    mesh = dispatch.execution_mesh()
    return mesh if mesh is not None and world_size() > 1 else None


def data_size() -> int:
    """The data axis of the registered mesh (1 with none)."""
    mesh = _registered()
    return mesh.data if mesh is not None else 1


def data_index() -> int:
    """This rank's coordinate on the data axis: the block of every global
    batch it feeds and the seed of its streams (0 with no mesh)."""
    mesh = _registered()
    return mesh.data_index if mesh is not None else 0


def process_local_batch_size(global_batch: int) -> int:
    """``split_batches``: the configured batch is global; each data replica
    feeds its 1 / data share (a model group's ranks feed the same rows)."""
    n = data_size()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} data replicas")
    return global_batch // n


def host_block(global_idx: np.ndarray, local_rows: int) -> np.ndarray:
    """This replica's contiguous block of a global batch's row indices: data
    coordinate i feeds rows [i * local_rows, (i + 1) * local_rows)."""
    i = data_index()
    return global_idx[i * local_rows:(i + 1) * local_rows]


def _groups(d: int, m: int):
    """Every rank creates every group of a shape, in one order; a shape's
    groups are made once and reused by later meshes of that shape."""
    if (d, m) not in _GROUPS:
        data_groups = ([dist.new_group([i * m + j for i in range(d)]) for j in range(m)]
                       if d > 1 and m > 1 else None)
        model_groups = ([dist.new_group([i * m + j for j in range(m)]) for i in range(d)]
                        if d > 1 and m > 1 else None)
        _GROUPS[(d, m)] = (data_groups, model_groups)
    return _GROUPS[(d, m)]


def make_mesh(shape: Optional[Sequence[int]] = None, tensor_parallel: bool = False) -> Mesh:
    """The (data, model) mesh over the world's processes, registered with
    ``ops/dispatch``. Default (world, 1); the product must equal the world
    size. ``tensor_parallel`` splits the parameters over a model axis above
    1 (``shard_params``); without it the model axis holds replicas."""
    n = world_size()
    shape = tuple(int(s) for s in (shape if shape is not None else (n, 1)))
    if len(shape) != 2 or int(np.prod(shape)) != n:
        raise ValueError(f"mesh_shape {shape} does not cover the {n} processes as (data, model)")
    d, m = shape
    r = rank()
    data_groups, model_groups = _groups(d, m) if n > 1 else (None, None)
    mesh = Mesh(data=d, model=m, tensor_parallel=bool(tensor_parallel) and m > 1, rank=r,
                data_group=data_groups[r % m] if data_groups else None,
                model_group=model_groups[r // m] if model_groups else None)
    dispatch.set_execution_mesh(mesh)
    return mesh


def data_parallel() -> bool:
    """Whether the data collectives act: a registered mesh with a data axis
    above 1, outside ``dispatch.local_execution``."""
    return data_size() > 1


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
    replicas in place, in one ``all_reduce`` over a flat buffer within the
    rank's data group (under tensor parallelism its members hold the same
    shards); an identity when no data mesh is active. Returns ``tensors``."""
    if op not in ("sum", "mean"):
        raise ValueError(f"unknown reduction {op!r}")
    if not tensors or not data_parallel():
        return tensors
    mesh = _registered()
    flat = _flat(tensors)
    _count()
    dist.all_reduce(flat, group=mesh.data_group)
    if op == "mean":
        flat.div_(mesh.data)
    _unflat_(tensors, flat)
    return tensors


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """A reduced copy of ``t`` (``t`` itself when no data mesh is active)."""
    if not data_parallel():
        return t
    return all_reduce_([t.clone()], "sum")[0]


def _spans_ranks() -> bool:
    mesh = _registered()
    return mesh is not None and mesh.size > 1


def broadcast_(tensors: List[torch.Tensor], src: int = 0) -> List[torch.Tensor]:
    """Overwrite ``tensors`` with rank ``src``'s, in one broadcast over the
    world per dtype; an identity when no mesh of several ranks is active.
    For whole (unsharded) trees: every rank must hold the same shapes."""
    if not tensors or not _spans_ranks():
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
    """Wait for every rank; an identity when no mesh of several ranks is active."""
    if _spans_ranks():
        _count()
        dist.barrier()


# ---------------------------------------------------------------------------
# Parameter sharding rules (JAX's, by the same path rules)
# ---------------------------------------------------------------------------

def retrieval_tp_spec(path: str, x) -> tuple:
    """The port's copy of JAX's ``_retrieval_tp_spec``: a (rows, cols) spec
    naming the dimension split over ``'model'``, or ``()`` (replicated).
    sem_emb rows (vocab-parallel); wqkv / wkv / wq / in_proj columns; attn
    and cross-attn proj / out_proj rows; FFN first columns, second rows."""
    if x.ndim < 2:
        return ()
    if "sem_emb" in path:
        return (MODEL_AXIS, None)
    if any(k in path for k in ("wqkv", "wkv", "wq", "in_proj")):
        return (None, MODEL_AXIS)
    if "proj" in path and "in_proj" not in path:
        return (MODEL_AXIS, None)
    if "ff_mlp" in path:
        idx = int(path.rsplit("[", 1)[-1].rstrip("]")) if path.endswith("]") else 0
        return (None, MODEL_AXIS) if idx == 0 else (MODEL_AXIS, None)
    return ()


def rqvae_tp_spec(path: str, x) -> tuple:
    """The port's copy of JAX's ``_rqvae_tp_spec``: codebook rows (K / m
    codewords a rank), sim_proj columns, encoder / decoder MLPs alternating
    columns (even layers) and rows (odd layers)."""
    if x.ndim < 2:
        return ()
    if "codebook" in path:
        return (MODEL_AXIS, None)
    if "sim_proj" in path:
        return (None, MODEL_AXIS)
    if "encoder[" in path or "decoder[" in path:
        idx = int(path.rsplit("[", 1)[-1].rstrip("]"))
        return (None, MODEL_AXIS) if idx % 2 == 0 else (MODEL_AXIS, None)
    return ()


def path_str(path: tuple) -> str:
    """JAX's ``_path_str`` of a ``tree_leaves_with_path`` path:
    ``("transformer", "encoder", 0, "attn", "wqkv")`` ->
    ``"transformer/encoder[0]/attn/wqkv"``."""
    parts = []
    for k in path:
        if isinstance(k, int):
            if parts:
                parts[-1] = parts[-1] + f"[{k}]"
            else:
                parts.append(f"[{k}]")
        else:
            parts.append(str(k))
    return "/".join(parts)


ATTENTION_LEAVES = ("/attn/", "/cross_attn/")


def leaf_spec(spec_fn: "SpecFn", path: str, x, heads: Optional[int], m: int) -> tuple:
    """The layout of one leaf on a model axis of ``m``: ``spec_fn``'s (JAX's
    rule), except that a retrieval model's attention leaves (self-attention
    ``wqkv`` / ``proj``, cross-attention ``wq`` / ``wkv`` / ``proj``) stay
    whole (``()``) when its ``heads`` do not divide over ``m``: each rank
    then computes every head (``parallel/tensor.heads_split``), as JAX's
    GSPMD does with attention it sends to the dense ``sdpa``. Every carve,
    gather, checkpoint and export reads its layout here."""
    if heads is not None and heads % m and any(k in f"/{path}" for k in ATTENTION_LEAVES):
        return ()
    return spec_fn(path, x)


def _blocks(path: str) -> int:
    """Column blocks carved separately: [q | k | v] and [k | v]."""
    return 3 if "wqkv" in path else 2 if "wkv" in path else 1


SpecFn = Callable[[str, torch.Tensor], tuple]


def _splits(tree, spec_fn: SpecFn, heads: Optional[int], m: int):
    """(path string, leaf, split dim or None, blocks) of every leaf, in
    ``tree_leaves_with_path`` order (``leaf_spec``). The rules read only
    paths and ranks, so a tree of shards gives its whole tree's answers."""
    if spec_fn is retrieval_tp_spec and heads is None:
        raise ValueError("the retrieval layout needs the model's heads: whole attention "
                         "leaves when they do not divide over the model axis")
    for path, x in tree_leaves_with_path(tree):
        p = path_str(path)
        spec = leaf_spec(spec_fn, p, x, heads, m)
        dim = spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None
        yield p, x, dim, (_blocks(p) if dim == 1 else 1)


def _carve(x: torch.Tensor, dim: int, blocks: int, m: int, j: int) -> torch.Tensor:
    return torch.cat([b.chunk(m, dim)[j] for b in x.chunk(blocks, dim)], dim).contiguous()


def _uncarve(shards: List[torch.Tensor], dim: int, blocks: int) -> torch.Tensor:
    per = [s.chunk(blocks, dim) for s in shards]
    return torch.cat([torch.cat([p[b] for p in per], dim) for b in range(blocks)], dim)


def _tp_mesh() -> Optional[Mesh]:
    mesh = dispatch.execution_mesh()
    return mesh if mesh is not None and mesh.tp > 1 and world_size() > 1 else None


def shard_params(tree, spec_fn: SpecFn, heads: Optional[int] = None):
    """This rank's shards of a whole tree (every rank holds the whole tree):
    the split dimension of each leaf cut into the model axis's parts, the
    rank's part kept; other leaves as they are. ``heads`` is the retrieval
    model's (required with ``retrieval_tp_spec``): heads that do not divide
    over the axis keep the attention leaves whole (``leaf_spec``). Every
    split dimension must divide over the axis, else ``ValueError`` with the
    numbers, as JAX's ``device_put`` refuses an uneven shard. The tree itself
    when the registered mesh splits nothing."""
    mesh = _tp_mesh()
    if mesh is None:
        return tree
    m, j = mesh.tp, mesh.model_index
    out = []
    for p, x, dim, blocks in _splits(tree, spec_fn, heads, m):
        if dim is not None and x.shape[dim] % (blocks * m):
            raise ValueError(f"{p} {tuple(x.shape)}: dim {dim} of {x.shape[dim]}"
                             f"{f' ({blocks} blocks)' if blocks > 1 else ''} does not divide "
                             f"over a model axis of {m}")
        out.append(x if dim is None else _carve(x, dim, blocks, m, j))
    return tree_unflatten(tree, out)


def gather_params(tree, spec_fn: SpecFn, heads: Optional[int] = None):
    """The whole tree from every rank's shards (``heads`` as for
    ``shard_params``): one list ``all_gather`` over the model group per
    dtype of the split leaves, then each leaf uncarved; whole leaves are
    kept as they are. A collective: every rank of the model group calls it.
    The tree itself when the registered mesh splits nothing."""
    mesh = _tp_mesh()
    if mesh is None:
        return tree
    splits = list(_splits(tree, spec_fn, heads, mesh.tp))
    out = [x for _, x, _, _ in splits]
    by_dtype = {}
    for i, (_, x, dim, _) in enumerate(splits):
        if dim is not None:
            by_dtype.setdefault(x.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([out[i].detach().reshape(-1) for i in idx])
        parts = [torch.empty_like(flat) for _ in range(mesh.tp)]
        _count()
        dist.all_gather(parts, flat, group=mesh.model_group)
        pieces = [part.split([out[i].numel() for i in idx]) for part in parts]
        for n, i in enumerate(idx):
            _, x, dim, blocks = splits[i]
            out[i] = _uncarve([pc[n].view(x.shape) for pc in pieces], dim, blocks)
    return tree_unflatten(tree, out)


def _map_state(state: dict, fn) -> dict:
    """``fn`` over ``state["params"]`` and, when present, the Adam moments of
    ``state["opt_state"]`` (the params' tree; ``count`` stays)."""
    out = dict(state)
    out["params"] = fn(state["params"])
    opt = state.get("opt_state")
    if opt is not None:
        out["opt_state"] = opt._replace(mu=fn(opt.mu), nu=fn(opt.nu))
    return out


def shard_state(state: dict, spec_fn: SpecFn, heads: Optional[int] = None) -> dict:
    """``shard_params`` over ``{"params", "opt_state"}``: the moments shard
    with their params (JAX's ``opt_state_shardings``)."""
    return _map_state(state, lambda t: shard_params(t, spec_fn, heads))


def gather_state(state: dict, spec_fn: SpecFn, heads: Optional[int] = None) -> dict:
    """``gather_params`` over ``{"params", "opt_state"}``; a collective."""
    return _map_state(state, lambda t: gather_params(t, spec_fn, heads))


def fetch_to_host(tree, spec_fn: Optional[SpecFn] = None, heads: Optional[int] = None):
    """Host copy of a device tree, whole: tensor-parallel shards are gathered
    first (``spec_fn`` and ``heads`` name the layout), so this is a
    collective then, as JAX's is in multi-process mode; every rank of the
    model group calls it."""
    if spec_fn is not None:
        tree = gather_params(tree, spec_fn, heads)
    return tree_map(lambda t: t.detach().cpu() if isinstance(t, torch.Tensor) else t, tree)
