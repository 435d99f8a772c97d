"""Public kernel entry points: the device of the tensors picks the route.

A CUDA tensor goes to the hand-written kernel, a CPU tensor to its plain
version in ``ref`` (the role ``repro.kernels.ops._interpret`` plays in
the reference).  A kernel that cannot build or launch raises; nothing
falls back.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import embedding_bag as _eb
from repro_torch.kernels import on_card, ref
from repro_torch.kernels import ssu_dedupe as _sd
from repro_torch.kernels import tracker_select as _ts


def embedding_bag(table, idx):
    """Sum-pooled lookup (B, hot) -> (B, d), differentiable in ``table``
    (dense gradient)."""
    return _eb.EmbeddingBag.apply(table, idx)


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
