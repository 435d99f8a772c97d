"""Fig. 14 (new): save-event critical-path latency, sync vs async engine.

Check-N-Run's core observation applied to this repo: what matters for
training throughput is not how long a checkpoint takes to *complete* but
how long the training thread is *blocked* per save event.  We measure that
critical path on the scaled DLRM (Criteo Kaggle layout) for

  * the synchronous ``CheckpointStore`` (apply + optional disk persist on
    the training thread), vs
  * the ``AsyncCheckpointWriter`` (host snapshot + enqueue only; apply and
    persist overlap training on the background thread),

on both the memory backend (emulation path) and the disk backend
(compressed .npz persist — the production-shaped cost), across scaled
table sizes.  Each event is timed from an idle queue (fence between
events, excluded from the per-event figure) so the number is pure
critical-path latency, not back-pressure.  Both engines save from device
tensors, as the training loop does.

Also reports the at-save tracker-selection path: the global ``mfu_select``
with a full-id round trip to the host vs the segment-wise
``mfu_select_segmented`` (the ``tracker_select`` kernel on the card, its
plain version on the CPU), with an exact-match check against the plain
version.  The row keys are the reference's (``pallas_seg_ms`` is the
segment-wise path's time).
"""
from __future__ import annotations

import tempfile

import numpy as np
import torch

from benchmarks_torch.common import time_events
from repro_torch import resolve_device
from repro_torch.configs.dlrm import DLRM_KAGGLE, scaled
from repro_torch.core import trackers as trk
from repro_torch.core.checkpoint import (AsyncCheckpointWriter,
                                         CheckpointStore, EmbShardSpec)
from repro_torch.kernels import ref


def _state(sizes, d, seed=0):
    rng = np.random.default_rng(seed)
    tables = [rng.normal(size=(n, d)).astype(np.float32) for n in sizes]
    accs = [np.zeros(n, np.float32) for n in sizes]
    return tables, accs


def _bench_backend(sizes, d, events, directory, device):
    tables, accs = _state(sizes, d)
    spec = EmbShardSpec(sizes, 8)
    # save from device tensors, like the training loop does: both engines
    # then pay one device-to-host copy; sync additionally applies (and
    # persists) on the critical path
    dev_t = [torch.as_tensor(t, device=device) for t in tables]
    dev_a = [torch.as_tensor(a, device=device) for a in accs]
    sync_store = CheckpointStore(tables, accs, spec, directory=directory)
    sync_ms = time_events(
        lambda: sync_store.save_full(dev_t, dev_a, step=0), events, device)
    astore = CheckpointStore(tables, accs, spec, directory=directory)
    writer = AsyncCheckpointWriter(astore)
    async_ms = time_events(
        lambda: writer.save_full(dev_t, dev_a, step=0), events, device,
        after=writer.fence)
    writer.close()
    if astore.bytes_written != sync_store.bytes_written:    # parity audit
        raise AssertionError(f"async engine wrote {astore.bytes_written} "
                             f"bytes, sync {sync_store.bytes_written}")
    return sync_ms, async_ms


def run(max_rows=(20_000, 60_000), events=5, select_sizes=(50_000, 200_000),
        r=0.125, device=None):
    dev = resolve_device(device)
    rows = []
    for mr in max_rows:
        cfg = scaled(DLRM_KAGGLE, max_rows=mr)
        sizes, d = cfg.table_sizes, cfg.emb_dim
        total = sum(sizes)
        for backend in ("memory", "disk"):
            if backend == "disk":
                with tempfile.TemporaryDirectory() as tmp:
                    sync_ms, async_ms = _bench_backend(sizes, d, events, tmp,
                                                       dev)
            else:
                sync_ms, async_ms = _bench_backend(sizes, d, events, None,
                                                   dev)
            rows.append({
                "figure": "fig14", "kind": "save_event", "backend": backend,
                "max_rows": mr, "total_rows": total,
                "bytes": total * (d + 1) * 4,
                "sync_crit_ms": round(sync_ms, 3),
                "async_crit_ms": round(async_ms, 3),
                "speedup": round(sync_ms / max(async_ms, 1e-9), 2),
            })

    # ---- at-save tracker selection: global vs segment-wise ----
    for N in select_sizes:
        rn = int(r * N)
        counts = torch.as_tensor(
            np.random.default_rng(1).integers(0, 1000, N).astype(np.int32),
            device=dev)
        pend = torch.zeros((0,), dtype=torch.int32, device=dev)

        def host():
            idx, new_c = trk.mfu_select(counts, rn)
            return idx.cpu().numpy(), new_c

        def segmented():
            idx, new_c = trk.mfu_select_segmented(counts, rn, indices=pend)
            return idx.cpu().numpy(), new_c

        host()      # warm-up
        idx_s, new_s = segmented()
        # exact-match audit vs the plain version (same (seg, k) plan the
        # wrapper used)
        seg, k = trk.segmented_k(N, rn)
        ref_idx, ref_cnt = ref.tracker_select(
            counts.cpu(), torch.zeros(0, dtype=torch.int64), k, seg_size=seg)
        exact = (np.array_equal(idx_s, ref_idx.numpy()) and
                 torch.equal(new_s.cpu(), ref_cnt))
        t_host = time_events(host, 5, dev)
        t_seg = time_events(segmented, 5, dev)
        rows.append({
            "figure": "fig14", "kind": "tracker_select", "rows": N,
            "rn": rn, "host_topk_ms": round(t_host, 3),
            "pallas_seg_ms": round(t_seg, 3),
            "matches_numpy_ref": bool(exact),
        })
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rows
