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

A sharded serve step attends over the rank's piece of a KV cache:
``merge_attention`` all-gathers the pieces' partial outputs with their
log-sum-exps and combines them (``merge_pieces``, the arithmetic alone),
and ``StatePiece`` is one layer's decode state on a rank: its cache
pieces' global slot and head ranges, and its recurrent leaves gathered
for the layer and cut back to the rank's slice after it.
"""
from __future__ import annotations

import torch
import torch.distributed._functional_collectives as fc

from repro_torch.sharding.specs import (P, axes_of, axis_sizes, dim_range,
                                        local_shard, mesh_coords)

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
    sizes = axis_sizes(mesh)
    for d, entry in enumerate(spec):
        for a in reversed(axes_of(entry)):
            if a not in keep and sizes[a] > 1:
                t = all_gather(t, d, mesh, a)
    return t


class ShardedStack:
    """A stacked stage leaf's shard (R, ...) under ``spec`` (whose first
    entry, the stacking axis, is unsharded).  ``s[r]`` is repetition r
    gathered whole (but over ``keep``), differentiable into the shard."""

    def __init__(self, local, spec: P, mesh, keep=()):
        self.local, self.spec, self.mesh, self.keep = local, spec, mesh, keep
        # ``gather``'s (dim, axis) steps for a repetition, worked out once:
        # a decode step indexes every leaf of every layer, on the host path
        sizes = axis_sizes(mesh)
        self._steps = [(d, a) for d, entry in enumerate(list(spec)[1:])
                       for a in reversed(axes_of(entry))
                       if a not in keep and sizes[a] > 1]

    def __getitem__(self, r):
        t = self.local[r]
        for d, a in self._steps:
            t = all_gather(t, d, self.mesh, a)
        return t


# --------------------------------------------------------------------------
# attention over a sequence-sharded KV cache
# --------------------------------------------------------------------------
def merge_pieces(o, lse):
    """The attention over the union of R pieces of the keys from each
    piece's: ``o`` (R, ..., hd) its f32 output, ``lse`` (R, ...) its
    log-sum-exp -> sum_r exp(lse_r - L) * o_r, L = logsumexp_r lse_r,
    summed in piece order (equal inputs give bit-equal outputs).  A piece
    with no valid key has lse -inf and weight exactly 0; where every piece
    is empty the output is 0, never NaN."""
    L = torch.logsumexp(lse, dim=0)
    L = torch.where(torch.isfinite(L), L, torch.zeros_like(L))
    w = torch.exp(lse - L)[..., None]
    out = w[0] * o[0]
    for r in range(1, o.shape[0]):
        out = out + w[r] * o[r]
    return out


def merge_attention(o, lse, mesh, axes):
    """The rank's partial attention ``o`` (..., hd) f32 with its ``lse``
    (...) merged with the other pieces' over the mesh ``axes`` that split
    the cache's sequence: one all-gather per axis of both together, the
    pieces in shard order (the first axis the major one), then
    ``merge_pieces``.  Every rank of the group gets the same bits."""
    t = torch.cat([o, lse[..., None]], dim=-1)[None]
    for a in reversed(axes_of(axes)):
        t = all_gather(t, 0, mesh, a)
    return merge_pieces(t[..., :-1], t[..., -1])


CACHE_LEAVES = ("k", "v", "ks", "vs")


class StatePiece:
    """One layer's decode state on a rank of a sharded serve step, under
    ``specs`` ({leaf name: spec}, the stacking axis dropped).  Dim 0 is
    the batch, which is the rank's own (its shard over dp, or all of it).

    The cache leaves (``CACHE_LEAVES``) stay the rank's pieces: ``range``
    gives a piece's global index range along a dim (slots, kv heads);
    ``seq_axes`` split the slots (the attention is merged over them) and
    ``head_axes`` the kv heads (the heads' outputs are gathered over
    them), each the axes of more than one rank.  The other leaves (RG-LRU, mLSTM, sLSTM states, split along
    their width) are gathered for the layer (``gather``) and cut back to
    the rank's slice after it (``own``)."""

    def __init__(self, specs: dict, mesh):
        self.specs, self.mesh = specs, mesh
        self.sizes, self.coords = axis_sizes(mesh), mesh_coords(mesh)
        k = specs.get("k")

        def split(entry):                 # the axes of more than one rank
            return tuple(a for a in axes_of(entry) if self.sizes[a] > 1)
        self.seq_axes = split(k[1]) if k is not None else ()
        self.head_axes = split(k[2]) if k is not None else ()

    def range(self, name: str, dim: int, local_n: int) -> tuple:
        return dim_range(self.specs[name][dim], local_n, self.sizes,
                         self.coords)

    def extent(self, name: str, dim: int, local_n: int) -> int:
        """The whole leaf's length along ``dim``."""
        n = local_n
        for a in axes_of(self.specs[name][dim]):
            n *= self.sizes[a]
        return n

    def _width(self, name):
        return P(None, *list(self.specs[name])[1:])

    def gather(self, st):
        return {n: t if n in CACHE_LEAVES
                else gather(t, self._width(n), self.mesh)
                for n, t in st.items()}

    def own(self, name: str, t):
        return local_shard(t, self._width(name), self.sizes, self.coords)
