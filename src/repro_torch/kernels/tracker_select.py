"""Fused CPR-MFU counter update + segment-wise top-k on Hopper.

Replaces ``repro.kernels.tracker_select.tracker_select`` (Pallas); the CUDA
source is ``csrc/tracker_select.cu``, which says what bounds it.  The TPU
version needed ``seg`` to be a multiple of the 128-wide lane dimension; on
this card any ``seg`` up to ``MAX_SEG`` works: a team of one warp (``seg``
<= 512, the main path) up to 32 warps holds a segment in registers, 16
counters a thread, so ``MAX_SEG`` is 32 * 32 * 16 rows.

``autotune_seg_size`` times the candidate segment widths on the device
the caller names: CUDA events on the card, the host clock on the CPU.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import (LAUNCHES, _host, launch_on,
                                 on_card, ref, require, stream_of)

MAX_SEG = 32 * 32 * 16      # a 1024-thread team, 16 counters a thread


def tracker_select(counts: torch.Tensor, indices: torch.Tensor, k: int,
                   seg_size: int = 512):
    """Kernel launch.  counts (N,) int32, indices (n,) int32 pending ids
    (may be empty) -> (row_ids (n_seg*k,) int32, new_counts (N,) int32).

    Row ids reaching past N are padding-segment picks; callers drop them.
    The caller's ``counts`` are left as they were.  The checks (contiguous
    1-D int32 on one device, 1 <= k, seg <= ``MAX_SEG``), allocation and
    launch run in the C++ host module."""
    require(counts.is_cuda, "tracker_select launches a CUDA kernel: counts "
            "must be on a CUDA device")
    out = launch_on(counts.get_device(), _host.module().tracker_select,
                    counts, indices, k, seg_size, stream_of(counts))
    if counts.shape[0]:
        LAUNCHES["tracker_select"] += 1
    return out


def autotune_seg_size(n_rows: int, k: int,
                      candidates=(128, 256, 512, 1024, 2048),
                      pending: int = 512, trials: int = 3, seed: int = 0,
                      device=None) -> int:
    """Pick ``seg_size`` by measurement on a representative
    ``(n_rows, k)`` workload: the candidate with the best
    min-over-``trials`` time wins.  Candidates wider than the table are
    skipped once one has been timed.  ``CPRManager`` surfaces the choice in
    ``report()["seg_size"]`` when configured with ``seg_size="auto"``."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_rows = max(int(n_rows), 1)
    counts = torch.from_numpy(
        rng.integers(0, 64, size=n_rows, dtype=np.int32)).to(device)
    idx = torch.from_numpy(rng.integers(
        0, n_rows, size=max(1, min(n_rows, pending)),
        dtype=np.int32)).to(device)
    card = on_card(counts, idx)
    select = tracker_select if card else ref.tracker_select
    best_seg, best_t = None, None
    for seg in candidates:
        if seg > n_rows and best_seg is not None:
            continue
        kk = max(1, min(int(k), seg))
        select(counts, idx, kk, seg_size=seg)          # build/warm outside
        t = None
        for _ in range(max(1, trials)):
            if card:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                select(counts, idx, kk, seg_size=seg)
                end.record()
                end.synchronize()
                dt = start.elapsed_time(end) / 1e3
            else:
                t0 = time.perf_counter()
                select(counts, idx, kk, seg_size=seg)
                dt = time.perf_counter() - t0
            t = dt if t is None else min(t, dt)
        if best_t is None or t < best_t:
            best_seg, best_t = seg, t
    if best_seg is None:
        raise ValueError(f"no seg_size candidate in {tuple(candidates)}")
    return best_seg
