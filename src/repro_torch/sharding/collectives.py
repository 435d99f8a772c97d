"""Every collective the port issues, through one counter.

``all_gather``, ``all_to_all`` and ``all_reduce`` run over one axis of a
``DeviceMesh`` (its process group) with ``torch.distributed``'s functional
collectives, and are differentiable: each is an autograd Function whose
backward is its adjoint collective (an all-gather's a reduce-scatter,
an all-to-all's an all-to-all, an all-reduce sum's an all-reduce sum),
counted as well.  An axis of one rank issues nothing.

The counter is keyed by kind and holds each collective's payload as the
reference's dry run counts it from the compiled HLO: the output bytes a
rank receives, payloads of 256 bytes or less (scalar syncs) left out of
the bytes but not of the calls.  ``counts()`` is the port's
``collective_bytes``.

``gather(t, spec, mesh)`` makes a whole tensor of a rank's shard, axis by
axis; ``ShardedStack`` holds a stacked stage leaf's shard and gathers one
repetition when indexed, so ``models.transformer._layer``'s ``t[r]``
gathers a layer's weights inside the layer's remat region.
"""
from __future__ import annotations

import torch
import torch.distributed._functional_collectives as fc

from repro_torch.sharding.specs import P, axes_of, axis_sizes

KINDS = ("all-gather", "reduce-scatter", "all-to-all", "all-reduce")
SMALL = 256     # bytes: the reference's cut for scalar syncs

_bytes = dict.fromkeys(KINDS, 0)
_calls = dict.fromkeys(KINDS, 0)

# torch 2.13 renamed the single-tensor collectives; older releases have
# only the first names
_all_gather = getattr(fc, "all_gather_single", None) or fc.all_gather_tensor
_reduce_scatter = (getattr(fc, "reduce_scatter_single", None)
                   or fc.reduce_scatter_tensor)


def reset_counts() -> None:
    for k in KINDS:
        _bytes[k] = 0
        _calls[k] = 0


def counts() -> dict:
    """{kind: payload bytes} with their ``total``, and ``calls`` by kind."""
    out = dict(_bytes)
    out["total"] = sum(_bytes.values())
    out["calls"] = dict(_calls)
    return out


def _count(kind: str, out: torch.Tensor) -> torch.Tensor:
    _calls[kind] += 1
    n = out.numel() * out.element_size()
    if n > SMALL:
        _bytes[kind] += n
    return out


def _wait(t):
    return fc.wait_tensor(t)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _count("all-gather",
                      _wait(_all_gather(x.contiguous(), dim, group)))

    @staticmethod
    def backward(ctx, g):
        return _ReduceScatter.apply(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _count("reduce-scatter", _wait(
            _reduce_scatter(x.contiguous(), "sum", dim, group)))

    @staticmethod
    def backward(ctx, g):
        return _AllGather.apply(g, ctx.dim, ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    """Equal splits of dim 0: chunk j goes to rank j, chunk i of the
    output came from rank i."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _count("all-to-all", _wait(
            fc.all_to_all_single(x.contiguous(), None, None, group)))

    @staticmethod
    def backward(ctx, g):
        return _AllToAll.apply(g, ctx.group), None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _count("all-reduce",
                      _wait(fc.all_reduce(x.contiguous(), "sum", group)))

    @staticmethod
    def backward(ctx, g):
        return _AllReduce.apply(g, ctx.group), None


def _group(mesh, axis):
    """The process group of ``axis``, or None for an axis of one rank."""
    if axis_sizes(mesh)[axis] == 1:
        return None
    return mesh.get_group(axis)


def all_gather(x, dim: int, mesh, axis: str):
    """The ranks' ``x`` along ``axis`` concatenated on ``dim``, in rank
    order; its gradient is reduce-scattered back."""
    g = _group(mesh, axis)
    return x if g is None else _AllGather.apply(x, dim, g)


def all_to_all(x, mesh, axis: str):
    """Chunk j of dim 0 to the rank j of ``axis``; the output's chunk i is
    the one rank i sent."""
    g = _group(mesh, axis)
    return x if g is None else _AllToAll.apply(x, g)


def all_reduce(x, mesh, axes):
    """The sum of ``x`` over the ranks of ``axes`` (a name or names)."""
    for a in axes_of(axes):
        g = _group(mesh, a)
        if g is not None:
            x = _AllReduce.apply(x, g)
    return x


def gather(t, spec: P, mesh, keep=()):
    """The whole tensor of a rank's shard ``t`` under ``spec``: each dim
    gathered over its axes, the minor axis first (the shard index is major
    to minor in the spec's order); axes in ``keep`` stay sharded."""
    for d, entry in enumerate(spec):
        for a in reversed(axes_of(entry)):
            if a not in keep:
                t = all_gather(t, d, mesh, a)
    return t


class ShardedStack:
    """A stacked stage leaf's shard (R, ...) under ``spec`` (whose first
    entry, the stacking axis, is unsharded).  ``s[r]`` is repetition r
    gathered whole (but over ``keep``), differentiable into the shard."""

    def __init__(self, local, spec: P, mesh, keep=()):
        self.local, self.spec, self.mesh, self.keep = local, spec, mesh, keep

    def __getitem__(self, r):
        return gather(self.local[r], P(*self.spec[1:]), self.mesh, self.keep)
