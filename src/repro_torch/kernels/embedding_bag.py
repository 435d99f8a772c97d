"""Embedding bags (gather + sum-pool) over all of a model's tables at once,
on Hopper, with a backward kernel.

Replaces ``repro.kernels.embedding_bag.embedding_bag`` (Pallas, forward
only, one table a call); the CUDA source is ``csrc/embedding_bag.cu``,
which says what bounds it.  ``EmbeddingBags`` is the autograd function the
model calls: on CUDA tensors its forward and its backward are one launch
each for every table, on CPU tensors they run the plain versions in
``ref``.  A single table is the T = 1 case.

The backward returns a **dense** (N_t, d) gradient per table, as the
reference's XLA gradient of ``jnp.sum(table[idx], 1)`` does, so rowwise
Adagrad sees the same gradient either way.  The T gradients are views of
one zeroed allocation.

The kernels' work is a few microseconds, so a call costs what its host
path costs: the checks of every table, the allocation and the launch run
in the C++ host module ``csrc/launch_host.cpp``, which takes the list of
tables in one crossing and calls the CUDA launchers whose addresses it was
given once.  The tables' pointers and row counts go to the kernel by
value; nothing is cached across calls.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import (LAUNCHES, _host, launch_on, on_card, ref,
                                 require, stream_of)


def forward(tables, sparse: torch.Tensor) -> torch.Tensor:
    """Kernel launch: T <= 64 tables (N_t, d) f32 or bf16, one dtype and
    d, contiguous, on one CUDA device; ``sparse`` (B, T, hot) int32,
    contiguous -> (B, T, d).  Raises ValueError on anything else."""
    require(len(tables) > 0 and tables[0].is_cuda, "forward launches a "
            "CUDA kernel: the tables must be on a CUDA device")
    first = tables[0]
    out = launch_on(first.get_device(), _host.module().embedding_bags_forward,
                    tables, sparse, stream_of(first))
    LAUNCHES["embedding_bag"] += 1
    return out


def _fits(g: torch.Tensor) -> bool:
    """(B, T, d) f32 read in place: contiguous rows, 16-byte aligned."""
    return (g.stride(2) == 1 and g.data_ptr() % 16 == 0
            and g.stride(0) % 4 == 0 and g.stride(1) % 4 == 0)


def backward(grad_out: torch.Tensor, sparse: torch.Tensor,
             rows) -> list:
    """Kernel launch: dense (rows[t], d) f32 table gradients, views of one
    zeroed allocation, from ``grad_out`` (B, T, d) f32 (read through its
    strides; rows contiguous and 16-byte aligned) by atomic adds."""
    require(grad_out.is_cuda, "backward launches a CUDA kernel: grad_out "
            "must be on a CUDA device")
    grads = launch_on(grad_out.get_device(),
                      _host.module().embedding_bags_backward, grad_out,
                      sparse, list(rows), stream_of(grad_out))
    LAUNCHES["embedding_bag_backward"] += 1
    return grads


class EmbeddingBags(torch.autograd.Function):
    """Sum-pooled lookups of T tables, ``apply(sparse, *tables)`` with
    ``sparse`` (B, T, hot) -> (B, T, d), with a dense gradient per table;
    the device of the tensors picks the kernels (CUDA) or the plain
    versions (CPU)."""

    @staticmethod
    def forward(ctx, sparse, *tables):
        ctx.save_for_backward(sparse)
        ctx.dtype = tables[0].dtype
        if any(ctx.needs_input_grad[1:]):
            ctx.rows = [t.shape[0] for t in tables]
        if on_card(tables[0], sparse):
            return forward(tables, sparse)
        return ref.embedding_bags(tables, sparse)

    @staticmethod
    def backward(ctx, grad_out):
        (sparse,) = ctx.saved_tensors
        g = grad_out.float()
        if on_card(g, sparse):
            grads = backward(g if _fits(g) else g.contiguous(), sparse,
                             ctx.rows)
        else:
            grads = ref.embedding_bags_backward(g, sparse, ctx.rows)
        return (None, *(x.to(ctx.dtype) for x in grads))
