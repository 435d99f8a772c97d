"""Paper Table 1: time and memory overhead of SCAR / CPR-MFU / CPR-SSU.

Times the per-step tracker update and the at-save selection (us per call on
the device the run picks: relative ordering is the claim), and reports the
analytic memory overhead relative to the embedding table.  On the card
the clock is read only after the device has finished the work queued
before it.
"""
from __future__ import annotations

import time

import torch

from benchmarks_torch.common import sync
from repro_torch import resolve_device
from repro_torch.core import trackers as trk


def _time(fn, *args, iters=20, device=None):
    fn(*args)  # warm-up (on the card: builds and loads what it launches)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    sync(device)
    return (time.perf_counter() - t0) / iters * 1e6


def run(N=200_000, d=16, batch=512, hot=1, r=0.125, device=None):
    dev = resolve_device(device)
    rn = int(r * N)
    gen = torch.Generator(device=dev).manual_seed(0)
    idx = torch.randint(0, N, (batch, hot), generator=gen, device=dev,
                        dtype=torch.int32)
    table = torch.randn((N, d), generator=gen, device=dev)
    table2 = table + 0.01 * torch.randn((N, d), generator=gen, device=dev)

    mfu_c = trk.mfu_init(N, dev)
    ssu_s = trk.ssu_init(rn, device=dev)
    scar_s = trk.scar_init(table)

    rows = []
    upd_mfu = _time(trk.mfu_update, mfu_c, idx, device=dev)
    sel_mfu = _time(lambda c: trk.mfu_select(c, rn), mfu_c, device=dev)
    upd_ssu = _time(lambda s, i: trk.ssu_update(s, i, 2), ssu_s, idx,
                    device=dev)
    sel_ssu = _time(trk.ssu_select, ssu_s, device=dev)
    sel_scar = _time(lambda s, t: trk.scar_select(s, t, rn), scar_s, table2,
                     device=dev)
    emb_bytes = d * 4
    for mode, upd, sel in (("mfu", upd_mfu, sel_mfu),
                           ("ssu", upd_ssu, sel_ssu),
                           ("scar", 0.0, sel_scar)):
        rows.append({
            "figure": "table1", "mode": mode, "rows": N,
            "update_us": round(upd, 1), "select_us": round(sel, 1),
            "mem_bytes": trk.tracker_memory_bytes(mode, N, emb_bytes, r),
            "mem_pct_of_table": round(
                100 * trk.tracker_memory_bytes(mode, N, emb_bytes, r)
                / (N * emb_bytes), 3),
        })
    return rows
