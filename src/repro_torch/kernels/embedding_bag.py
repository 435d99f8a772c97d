"""Embedding bag (gather + sum-pool) on Hopper, with a backward kernel.

Replaces ``repro.kernels.embedding_bag.embedding_bag`` (Pallas, forward
only); the CUDA source is ``csrc/embedding_bag.cu``, which says what bounds
it.  ``EmbeddingBag`` is the autograd function the model calls: on CUDA
tensors its forward and backward launch the kernels, on CPU tensors they
run the plain versions in ``ref``.

The backward returns a **dense** (N, d) gradient, as the reference's XLA
gradient of ``jnp.sum(table[idx], 1)`` does, so rowwise Adagrad sees the
same gradient either way.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import (LAUNCHES, _build, check_launch, on_card,
                                 ref, require, stream_of)

# (in, idx, out, n_rows, batch, hot, d, stream) -> CUDA error code
_ARGS = (_build.P, _build.P, _build.P, _build.LL, _build.I, _build.I,
         _build.I, _build.P)
_SIGS = {fn: (_build.I, _ARGS) for fn in (
    "embedding_bag_fwd_f32", "embedding_bag_fwd_bf16", "embedding_bag_bwd_f32")}


def _lib():
    return _build.load("embedding_bag", _SIGS)


def _check_idx(idx, device):
    require(idx.device == device, "idx must lie on the table's device")
    require(idx.dtype == torch.int32, f"idx must be int32, got {idx.dtype}")
    require(idx.dim() == 2 and idx.is_contiguous(),
            "idx must be a contiguous (B, hot) tensor")


def forward(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Kernel launch: table (N, d) f32/bf16, idx (B, hot) int32 -> (B, d)."""
    require(table.is_cuda, "forward launches a CUDA kernel: table must be "
            "on a CUDA device")
    require(table.dtype in (torch.float32, torch.bfloat16),
            f"table must be float32 or bfloat16, got {table.dtype}")
    require(table.dim() == 2 and table.is_contiguous(),
            "table must be a contiguous (N, d) tensor")
    _check_idx(idx, table.device)
    N, d = table.shape
    B, hot = idx.shape
    require(d * table.element_size() % 16 == 0 and table.data_ptr() % 16 == 0,
            "table rows must be whole 16-byte chunks, 16-byte aligned")
    out = torch.empty((B, d), dtype=table.dtype, device=table.device)
    fn = (_lib().embedding_bag_fwd_f32 if table.dtype == torch.float32
          else _lib().embedding_bag_fwd_bf16)
    with torch.cuda.device(table.device):
        rc = fn(table.data_ptr(), idx.data_ptr(), out.data_ptr(), N, B, hot,
                d, stream_of(table))
    check_launch(rc, "embedding_bag")
    LAUNCHES["embedding_bag"] += 1
    return out


def backward(grad_out: torch.Tensor, idx: torch.Tensor,
             n_rows: int) -> torch.Tensor:
    """Kernel launch: dense (n_rows, d) f32 table gradient from grad_out
    (B, d) f32, by atomic adds into a zeroed buffer."""
    require(grad_out.is_cuda, "backward launches a CUDA kernel: grad_out "
            "must be on a CUDA device")
    require(grad_out.dtype == torch.float32,
            f"grad_out must be float32, got {grad_out.dtype}")
    require(grad_out.dim() == 2 and grad_out.is_contiguous(),
            "grad_out must be a contiguous (B, d) tensor")
    _check_idx(idx, grad_out.device)
    B, d = grad_out.shape
    require(idx.shape[0] == B, "idx and grad_out disagree on B")
    require(d % 4 == 0 and grad_out.data_ptr() % 16 == 0,
            "grad_out rows must be whole float4 chunks, 16-byte aligned")
    grad = torch.zeros((n_rows, d), dtype=torch.float32,
                       device=grad_out.device)
    with torch.cuda.device(grad_out.device):
        rc = _lib().embedding_bag_bwd_f32(
            grad_out.data_ptr(), idx.data_ptr(), grad.data_ptr(), n_rows, B,
            idx.shape[1], d, stream_of(grad_out))
    check_launch(rc, "embedding_bag_backward")
    LAUNCHES["embedding_bag_backward"] += 1
    return grad


class EmbeddingBag(torch.autograd.Function):
    """Sum-pooled lookup with a dense table gradient; the device of the
    tensors picks the kernel (CUDA) or the plain version (CPU)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows, ctx.dtype = table.shape[0], table.dtype
        if on_card(table, idx):
            return forward(table, idx)
        return ref.embedding_bag(table, idx)

    @staticmethod
    def backward(ctx, grad_out):
        (idx,) = ctx.saved_tensors
        g = grad_out.float().contiguous()
        if on_card(g, idx):
            grad = backward(g, idx, ctx.n_rows)
        else:
            grad = ref.embedding_bag_backward(g, idx, ctx.n_rows)
        return grad.to(ctx.dtype), None
