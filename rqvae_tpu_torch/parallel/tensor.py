"""Megatron tensor parallelism over the mesh's model axis: the four
collective autograd functions and the cross-shard reductions the models use
(the port's explicit form of what GSPMD inserts for JAX's
``tp_param_shardings`` / ``rqvae_tp_param_shardings``).

Each rank of a model group holds its slice of every partitioned matrix
(``parallel/mesh.shard_params``) and a whole copy of every other leaf and of
every activation between the partitioned layers. The models call:

* ``copy_to_model``: forward identity, backward ``all_reduce``: the input of
  a column-parallel layer, whose gradient each rank holds only in part;
* ``reduce_from_model``: forward ``all_reduce``, backward identity: the
  output of a row-parallel layer (a partial sum on each rank);
* ``gather_from_model``: forward ``all_gather`` and concatenate along a dim,
  backward the rank's own slice: a column-parallel output made whole;
* ``scatter_to_model``: forward the rank's own slice, backward
  ``all_gather``: a whole activation fed to a row-parallel layer;

and ``argmin_over_model`` / ``max_over_model`` for the sharded codebook.
``heads_split`` / ``local_heads`` say how attention splits: by heads when
the heads divide over the model axis, else not at all (whole heads on every
rank).
Only ``all_reduce`` and the list form of ``all_gather`` are used: gloo
takes both on CUDA tensors, so two ranks can share one card.

``size()`` is the number of shards the registered mesh splits the
parameters into (``dispatch.model_axis_size``): 1 with no mesh, a mesh
without ``tensor_parallel``, a model axis of 1, or inside
``dispatch.local_execution``, and then every function here is an identity
that issues no collective. ``calls`` counts the collectives issued, by kind.
"""
from __future__ import annotations

import collections

import torch
import torch.distributed as dist

from rqvae_tpu_torch.ops import dispatch

calls = collections.Counter()   # collectives issued here, by kind; reset by the caller


def size() -> int:
    return dispatch.model_axis_size()


def index() -> int:
    """This rank's coordinate on the model axis (0 when ``size()`` is 1)."""
    return dispatch.execution_mesh().model_index if size() > 1 else 0


def _group():
    return dispatch.execution_mesh().model_group


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = x.contiguous().clone()
    calls["all_reduce"] += 1
    dist.all_reduce(out, op=op, group=group)
    return out


def _all_gather(x: torch.Tensor, dim: int, group, m: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(m)]
    calls["all_gather"] += 1
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _own(x: torch.Tensor, dim: int, m: int, j: int) -> torch.Tensor:
    n = x.shape[dim]
    if n % m:
        raise ValueError(f"dim {dim} of width {n} does not divide over a model axis of {m}")
    return x.narrow(dim, j * (n // m), n // m).contiguous()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, m, j):
        ctx.dim, ctx.m, ctx.j = dim, m, j
        return _all_gather(x, dim, group, m)

    @staticmethod
    def backward(ctx, g):
        return _own(g, ctx.dim, ctx.m, ctx.j), None, None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, m, j):
        ctx.dim, ctx.group, ctx.m = dim, group, m
        return _own(x, dim, m, j)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group, ctx.m), None, None, None, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    return _Copy.apply(x, _group()) if size() > 1 else x


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    return _Reduce.apply(x, _group()) if size() > 1 else x


def all_reduce_model(x: torch.Tensor) -> torch.Tensor:
    """A sum over the model group whose inputs AND consumers are
    rank-specific: forward ``all_reduce``, backward ``all_reduce`` (each
    rank holds part of the sum's gradient)."""
    return reduce_from_model(copy_to_model(x))


def gather_from_model(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    m = size()
    return _Gather.apply(x, dim % x.dim(), _group(), m, index()) if m > 1 else x


def scatter_to_model(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    m = size()
    return _Scatter.apply(x, dim % x.dim(), _group(), m, index()) if m > 1 else x


def own_slice(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """This rank's slice of a whole tensor along ``dim``, no collective and
    no gradient routing (dropout masks and noise drawn at full width)."""
    m = size()
    return _own(x, dim % x.dim(), m, index()) if m > 1 else x


def heads_split(num_heads: int) -> bool:
    """Whether attention is split by heads over the model axis: a model axis
    above 1 that ``num_heads`` divides. When the heads do not divide, every
    attention leaf stays whole on every rank and each rank computes all the
    heads (``parallel/mesh.leaf_spec``), the layout JAX takes there:
    ``attend`` sends such heads to the dense ``sdpa``, which GSPMD computes
    on replicated weights (``rqvae_tpu/ops/attention.py`` ``_shardable``).
    The port keeps the attention kernels on the whole heads instead; the
    result is the same."""
    m = size()
    return m > 1 and num_heads % m == 0


def local_heads(num_heads: int) -> int:
    """The heads each rank computes: ``num_heads`` / the model axis when they
    split over it (``heads_split``), else all ``num_heads``."""
    return num_heads // size() if heads_split(num_heads) else num_heads


def max_over_model(x: torch.Tensor) -> torch.Tensor:
    """Elementwise max over the model group, no gradient (a softmax shift)."""
    x = x.detach()
    return _all_reduce(x, _group(), dist.ReduceOp.MAX) if size() > 1 else x


def argmin_over_model(dist_local: torch.Tensor, offset: int) -> torch.Tensor:
    """The global argmin (int32) along the last dim of a (B, K / m) shard of
    a (B, K) matrix whose columns start at ``offset`` on this rank: each
    rank's (min, global index) pairs are gathered in one ``all_gather`` and
    the smallest wins; on equal minima the lowest global index, as
    ``torch.argmin`` over the whole row picks."""
    d = dist_local.detach()
    idx = torch.argmin(d, dim=-1)          # the first occurrence within the shard
    m = size()
    if m == 1:
        return idx.to(torch.int32)
    val = d.gather(-1, idx[..., None])[..., 0]
    pair = torch.stack([val.double(), (idx + offset).double()], dim=0)   # (2, B), exact
    every = _all_gather(pair[None], 0, _group(), m)                      # (m, 2, B)
    win = torch.argmin(every[:, 0], dim=0)   # first shard on ties: the lowest index
    return every[:, 1].gather(0, win[None])[0].to(torch.int32)
