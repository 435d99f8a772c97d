"""Public kernel entry points: the device of the tensors picks the route.

A CUDA tensor goes to the hand-written kernel, a CPU tensor to its plain
version in ``ref`` (the role ``repro.kernels.ops._interpret`` plays in
the reference).  A kernel that cannot build or launch raises; nothing
falls back.  ``embedding_bags``, ``flash_attention`` and ``rglru_scan``
are differentiable: their backwards pick the route the same way (the
backward kernels on the card, the plain backwards in ``ref`` on the
CPU).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import embedding_bag as _eb
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import on_card, ref
from repro_torch.kernels import rglru_scan as _rg
from repro_torch.kernels import row_hash as _rh
from repro_torch.kernels import ssu_dedupe as _sd
from repro_torch.kernels import tracker_select as _ts


def embedding_bags(tables, sparse):
    """Sum-pooled lookups of T tables (N_t, d) at once: ``sparse`` (B, T,
    hot) int32, read in place -> (B, T, d), differentiable in every table
    (dense gradients).  One kernel launch forward and one backward."""
    return _eb.EmbeddingBags.apply(sparse, *tables)


def embedding_bag(table, idx):
    """Sum-pooled lookup (B, hot) -> (B, d), differentiable in ``table``
    (dense gradient): the T = 1 case of ``embedding_bags``."""
    return embedding_bags([table], idx[:, None])[:, 0]


class _FlashAttention(torch.autograd.Function):
    """Attention over the kernel layout (B, H, S, hd); saves q, k, v, the
    output and, when an input needs a gradient, the forward's per-row
    log-sum-exp, which the backward then does not recompute (serving
    does not pay for it)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        ctx.mask = (causal, window, softcap)
        fwd = _fa.flash_attention if on_card(q, k, v) else ref.flash_attention
        if any(ctx.needs_input_grad[:3]):
            out, lse = fwd(q, k, v, causal=causal, window=window,
                           softcap=softcap, return_lse=True)
        else:
            out, lse = fwd(q, k, v, causal=causal, window=window,
                           softcap=softcap), None
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if on_card(q, k, v, out, dout):
            if not _fa._aligned(dout):
                # the model's layout (B, S, H, hd), dense
                dout = dout.transpose(1, 2).contiguous().transpose(1, 2)
            grads = _fa.flash_attention_backward(q, k, v, out, dout,
                                                 *ctx.mask, lse=lse)
        else:
            grads = ref.flash_attention_backward(q, k, v, out, dout,
                                                 *ctx.mask, lse=lse)
        return (*grads, None, None, None)


def flash_attention(q, k, v, causal=True, window=0, softcap=0.0):
    """Layer layout: q (B, Sq, Hq, hd), k/v (B, Skv, Hkv, hd) ->
    (B, Sq, Hq, hd), differentiable in q, k and v.  The kernels take the
    (B, H, S, hd) views in place."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return _FlashAttention.apply(qt, kt, vt, causal, window,
                                 softcap).transpose(1, 2)


class _RGLRUScan(torch.autograd.Function):
    """The scan; saves a and the output h for the backward."""

    @staticmethod
    def forward(ctx, a, b):
        if on_card(a, b):
            a, b = a.contiguous(), b.contiguous()
            h = _rg.rglru_scan(a, b)
        else:
            h = ref.rglru_scan(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        if on_card(a, h, dh):
            return _rg.rglru_scan_backward(a, h, dh.contiguous())
        return ref.rglru_scan_backward(a, h, dh)


def rglru_scan(a, b):
    """h_t = a_t * h_{t-1} + b_t over axis 1 of (B, S, w), h_0 = 0,
    differentiable in a and b."""
    return _RGLRUScan.apply(a, b)


def tracker_select(counts, indices, k: int, seg_size: int = 512):
    """Fused MFU count fold + segment-wise top-k row selection.  Pending
    ``indices`` of any integer dtype are taken as int32, as the reference
    does."""
    flat = indices.reshape(-1).to(torch.int32).contiguous()
    if on_card(counts, flat):
        return _ts.tracker_select(counts, flat, k, seg_size=seg_size)
    return ref.tracker_select(counts, flat, k, seg_size=seg_size)


def autotune_seg_size(n_rows: int, k: int, **kw) -> int:
    """Measured ``seg_size`` choice for ``tracker_select``."""
    return _ts.autotune_seg_size(n_rows, k, **kw)


def ssu_dedupe_evict(buf, cand, scores):
    """Fused SSU reservoir dedupe + random-evict (sorted int32 buffer)."""
    if on_card(buf, cand, scores):
        return _sd.ssu_dedupe_evict(buf, cand, scores)
    return ref.ssu_dedupe_evict(buf, cand, scores)


def row_hash(values, accs):
    """Per-row FNV-1a of (value row, accumulator row) bytes -> (n,) int64
    holding the uint64 bits.  The kernel reads rows in place, so CUDA
    inputs must be contiguous."""
    if on_card(values, accs):
        return _rh.row_hash(values, accs)
    return ref.row_hash(values, accs)
