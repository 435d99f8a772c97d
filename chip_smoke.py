"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, drive, time.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase catches its own failure):

1. The card (``nvidia-smi`` name and power limit) and the kernel build:
   every ``src/repro_torch/csrc/*.cu`` compiled by ``nvcc`` for sm_90a,
   each kernel's registers and spills, and the count of tensor-core
   (HGMMA) instructions in the bf16 ``flash_attention``'s SASS (0 fails).
2. Each kernel against its plain PyTorch version at the shapes of the
   DLRM main path (largest Criteo-Kaggle table: N = 10,131,227, d = 16,
   B = 512; ``embedding_bag`` as one table and, the path's own call, over
   all 26 unscaled tables with ``sparse`` (512, 26, 1), one launch each
   way, beside the kernel's own device time from ``torch.profiler``), with
   its time (CUDA events, median of 25 after warm-up), the
   plain version's time, its bound (the bytes this run's inputs need over
   3.35 TB/s, or operations over the f32 peak, whichever is larger) and,
   where one PyTorch call computes the same function, that call's time.
   ``ssu_dedupe_evict`` takes raw candidates (repeats, draw order) and is
   timed without overflow (the path's steady state, the one in the
   kernels line) and with it; the profiler counts its CUDA kernels per
   call (more than 2 in the steady state fails); past one tile (16,384 and
   65,536 candidates, half-full and full reservoir) it must equal its
   plain version under ``torch.equal`` and is timed beside its bound; and
   full-width ``ssu_update(..., backend="kernel")`` calls with 256 and
   16,384 candidates run under ``torch.cuda.set_sync_debug_mode("error")``
   (a host sync fails).
   ``tracker_select``'s line adds ``torch.topk`` over the (n_seg, seg)
   view as a yardstick (selection only: no tie order, no clearing).  Both
   tracker kernels also print their time per call over 100 calls back to
   back (CUDA events) and their own device time (profiler).  ``row_hash`` is held
   bit for bit against its plain version on that table (f32 and a bf16
   copy, each with its f32 accumulator), a ragged width (d = 9), no rows
   and zero-byte rows; the number of differing words must be 0.  The
   widened contracts, timed beside their plain versions and equal to
   them: ``tracker_select`` at segments of 65,536 rows (past a team's
   16,384: a block a segment), ``embedding_bags`` over the 26 tables as
   12-byte rows (the element path) and over 130 tables (groups of 64).
3. The main path: the port's ``Emulator`` trains the unscaled Criteo-Kaggle
   DLRM (26 tables, 33,762,577 rows, d = 16) under 2 injected failures in
   modes ``full``, ``cpr-mfu`` and ``cpr-ssu`` (kernel tracker backend),
   at batch 512, then evaluates: first on the flat store (STEPS_FLAT
   steps), then on the sharded writer fleet (STEPS_FLEET steps; 8 shards,
   ``transport="inproc"``, delta saves with the ``row_hash`` kernel
   ledger).  Launch counts are reset just before each run and read just
   after; every train step launches ``embedding_bag`` once forward and
   once backward (evaluation adds one forward per batch); the priority
   modes must restore from the fleet.
4. The output checked against a reference on a small input: the scaled
   config trained on the card and on the CPU (the CPU path is held against
   the JAX reference by the tests) from the same parameters gives the same
   PLS, overhead charges, bytes written and delta counts, and an AUC
   within 5e-3 — on the flat store, and through the fleet over the pipe
   and the socket transports (the card hashes with the kernel, the CPU
   with the host ledger); the fleet's writer alone on the card and on the
   CPU gives the same images, in-place restores, bytes and delta counts
   after a ``save_full`` and a delta ``save_rows``.  A ``cpr-mfu`` run
   with a disk directory through ``pipe`` then reloads with
   ``load_latest_auto`` to its writers' fenced image byte for byte, and
   every pipe writer process reports from inside that it never created a
   CUDA context.  Phase 2 checks the kernels
   alone; this checks what the whole path on the card (trackers, saves,
   the fleet, restores, evaluation) hands back.

5. The port's benchmark harness (``benchmarks_torch``) on the card:
   (a) fig7's Kaggle rows at full Criteo-Kaggle width (33,762,577 rows,
   the published config), all six modes with the kernel tracker backend,
   steps cut to phase 3's 35; each row with its launches by kernel
   (``embedding_bag`` both ways in every mode, ``tracker_select`` in
   ``cpr-mfu``, ``ssu_dedupe_evict`` in ``cpr-ssu``; none may be 0) and a
   load charge below full recovery's in the partial-recovery modes; (b)
   fig7's ``--fast`` Kaggle rows (scaled), all six modes with the host
   backend, on the card and on the CPU from the same parameters: identical
   policy fields, and for ``full`` and ``cpr-mfu`` AUC and eval logloss
   within ``FIG7_AUC_GAP`` and ``FIG7_LOGLOSS_GAP`` of the CPU's (limits
   set from ``python -m benchmarks_torch.fig7_spread``); (c) ``table1``
   and ``fig14`` at ``--fast`` size (``fig14``'s selection must launch
   ``tracker_select`` and equal the plain version, and its engines' bytes
   agree); (d) both ``examples/torch_*.py`` as processes on the card,
   each exiting 0 with its summary lines.  Rows print with the card's
   ``nvidia-smi`` name and power limit.
6. The fleet figures (``benchmarks_torch`` fig15-17) on the card, the
   trainer's tables on the device: (a) fig15 at the published Kaggle
   width (33,762,577 rows, d = 16, 2.30 GB of tables and accumulators),
   8 shards, one event: save events (memory, disk) and delta saves; its
   ``delta_save`` rows must equal the same rows computed on the CPU (the
   plain hash); (b) at ``--fast`` size (26,777 rows), 2 shards: the pipe
   fleet's shm against spool snapshots, the socket fleet and its codec
   row (zlib level 6), the bytes a writer crash loses with and without
   XOR parity, and a re-admission; (c) fig16 (inproc and pipe, the 2 -> 4
   split) and fig17 (2 shards) at ``--fast`` size, fig17's
   ``hash_kernel`` at the largest Kaggle table's 10,131,227 x 16 (the
   cuts and why: FIG15_FULL).  Every audit field must be true and
   ``unchanged_resave_bytes`` 0; the phase
   must launch ``row_hash`` (its count goes in the kernels line as
   ``harness_launches``); no pipe writer or socket server process may
   create a CUDA context (each reports from inside).  The free disk space
   under the temporary directory and the host's available memory are
   printed first, and the phase stops with a plain message if they are
   short.

The LM serving path (RecurrentGemma-2B at full width, the DLRM tensors
freed first):

2b. ``flash_attention`` and ``rglru_scan`` against their plain versions at
   the path's shapes: (2, 10, 4096, 256) bf16 queries over (2, 1, 4096,
   256) keys with window 2048, gemma2's (1, 8, 4096, 256) over (1, 4,
   4096, 256) global with softcap 50, the reduced f32 case, and phase 4b's
   f32 prefill shape (2, 10, 2176, 256) over (2, 1, 2176, 256) (the f32
   FMA kernel at full width, beside f32 SDPA with TF32 off); the scan at
   (2, 4096, 2560) f32 and bf16 (bit for bit), with its own device time
   (profiler) and, as a yardstick, one ``torch.add`` over the same
   tensors, which moves the same bytes.  bf16 attention outputs
   must agree within 1e-2 * |plain| + 4e-3 (one bf16 rounding and some),
   and the plain version with its window one key tile (64) short must
   fall outside that limit.  Bounds: the unmasked band's flops over the peak
   of the dtype's arithmetic (bf16 tensor cores, f32 FMA) or the bytes,
   whichever is larger; library time: ``F.scaled_dot_product_attention``
   with the band as its mask where there is no softcap.
3b. The main path: RecurrentGemma-2B parameters (f32) drawn on the card,
   one prefill ``forward`` over (2, 4096) tokens in bf16, then ``serve()``
   answers 8 requests (prompts up to 64 tokens, batch 4, 32 generated).
   Counts are reset before the forward and read after ``serve()``:
   ``flash_attention`` must have launched 8 times (the local-attention
   layers) and ``rglru_scan`` 18 (the RG-LRU layers).  Then the prefill's
   time (the median of 5 forwards) and a decode step's time at batch 4
   past the window (a full 2,048-slot ring per local layer), the
   workload of ``python -m repro_torch.launch.profile_serve``.
4b. At full width in f32, prefill (``forward``, through both kernels) and
   decode (``decode_step`` teacher-forced over the same 2,176 tokens, past
   the window) give the same logits at every position within 1e-4 of the
   largest logit (the steps past the window are timed); at the reduced
   config, the card and the CPU give the
   same ``forward`` logits within 1e-4 and identical greedy ``serve()``
   completions.

The last two lines are ``{"kernels": [...]}`` and ``{"ok": true, ...}``.
"""
from __future__ import annotations

import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
N_BIG, D, B = 10_131_227, 16, 512
STEPS_FLAT = 35
STEPS_FLEET = 35
N_RAGGED = 1_000_003                  # rows of the d = 9 row_hash case
FLEET = {"sharded_save": True, "delta_saves": True, "hash_backend": "kernel",
         "transport": "inproc"}
# the LM serving path (phases 2b-4b): RecurrentGemma-2B at full width; the
# workload of phase 3b is repro_torch.launch.profile_serve's (ARCH,
# PREFILL_SHAPE, PREFILL_REPS, DECODE_*), imported in main()
AGREE_SEQ = 2176             # prefill vs decode: past the window, ring wraps
# flash_attention cases of phase 2b: name, (B, Hq, Hkv, S, hd), dtype,
# window, softcap, (rtol, atol); the first is the serving path's own.  The
# kernel and the plain version read the same inputs and both sum in f32,
# so bf16 outputs may differ by one rounding (at most 2**-7 of the value)
FLASH_CASES = (
    ("recurrentgemma-2b prefill", (2, 10, 1, 4096, 256), torch.bfloat16,
     2048, 0.0, (1e-2, 4e-3)),
    ("gemma2-2b global", (1, 8, 4, 4096, 256), torch.bfloat16, 0, 50.0,
     (1e-2, 4e-3)),
    ("recurrentgemma-2b reduced", (2, 4, 1, 128, 64), torch.float32, 64, 0.0,
     (0.0, 2e-5)),
    # phase 4b's f32 prefill: the FMA kernel at full width (the card tests'
    # f32 limit)
    ("recurrentgemma-2b f32 (phase 4b)", (2, 10, 1, AGREE_SEQ, 256),
     torch.float32, 2048, 0.0, (2e-5, 2e-5)))
KEY_TILE = 64                # keys per tile of csrc/flash_attention_bf16.cu
SCAN_SHAPE = (2, 4096, 2560)  # the RG-LRU layers' (B, S, width) at prefill
SCRATCH = Path(__file__).resolve().parent / "build" / "chip_smoke"
# phase 5: the benchmark harness.  fig7's policy fields must be equal on the
# card and the CPU.  At the harness's size (70 steps) the trained model
# depends on the order of float sums (the card's embedding backward adds
# atomically, in a run-dependent order; the CPU's AUC moves with its thread
# count), so in ``full`` and ``cpr-mfu`` the card's AUC and eval logloss
# are held to the CPU's within limits set from that measured spread.  A
# card path that trains wrongly misses them by far more
FIG7_POLICY = ("overhead_frac", "save_h", "load_h", "lost_h", "resched_h",
               "pls", "overhead_reduction_pct")
FIG7_HELD = ("full", "cpr-mfu")
FIG7_AUC_GAP = 3e-2       # measured up to 1.33e-2; untrained 0.34 away
FIG7_LOGLOSS_GAP = 0.2    # measured up to 5.13e-2; untrained 0.23 away
EXAMPLE_LINES = {    # example -> (a summary line, how many it prints)
    "torch_quickstart.py": (r"^\s*(full|cpr-mfu) auc=0\.\d{4} pls=", 2),
    "torch_cpr_tradeoff.py": (r"^  PLS=\S+\s+auc=0\.\d{4} overhead=", 3)}
PROBE_ENV = "CHIP_SMOKE_WRITER_PROBE_DIR"
# phase 6: the fleet figures.  Audit fields that must be true in every row
# that has them; the disk and host memory the full-width fig15 needs (two
# compressed 2.3 GB images on disk at once, the sync store, a writer's
# image, the pinned snapshots and the oracle's copies in host memory)
FLEET_AUDITS = ("image_matches_sync", "image_matches_oracle",
                "image_matches_raw", "parity_strictly_below",
                "parity_image_matches_oracle", "readmit_ok",
                "compressed_fewer_bytes", "shm_verified",
                "hash_kernel_exact")
FLEET_DISK_BYTES = 12e9
FLEET_RAM_BYTES = 32e9
# fig15 at the published width: 8 shards, one event (cut from 2: the flat
# store persists 2.3 GB compressed on one core, 110 s an event on the
# card's host).  Every fleet of writer processes (pipe, socket, the crash
# and re-admission drills) takes minutes at that width on that host (the
# socket fleet 108 s for one event, the pipe fleet's image fetch alone
# more than 690 s; PERF.md section 6), so those kinds run at --fast size,
# with 2 shards, as fig16 (one transition of two) and fig17 (2 shards)
# do: each spawned writer or server takes seconds to start there
FIG15_FULL = {"n_shards": (8,), "events": 1, "lost_shards": (8,),
              "kinds": ("save_event", "delta_save")}
FIG15_FLEETS = {"n_shards": (2,), "lost_shards": (2,),
                "kinds": ("pipe_snapshot_path", "socket_save_event",
                          "socket_wire_bytes", "bytes_lost_at_crash",
                          "readmission")}
FIG16_CUT = {"transitions": ((2, 4),)}
FIG17_CUT = {"n_shards": 2}


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, ops: float = 0.0, ops_per_s: float = F32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def zipf_ids(rng, n_rows, shape):
    perm = rng.permutation(n_rows)
    ranks = np.minimum(rng.zipf(1.2, size=shape) - 1, n_rows - 1)
    return perm[ranks].astype(np.int32)


def run_ms(fn, n: int = 100) -> float:
    """CUDA-event ms per call over ``n`` calls back to back: the host
    enqueues while the card runs, so a call's host path shows only where
    it is longer than its device work (``time_ms`` times one call, its
    host path before the launch included)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def time_pair_ms(fn_a, fn_b, reps: int = 101, warmup: int = 5):
    """``time_ms`` of two calls taken in turns (a, b, b, a, ...), so that
    host-bound calls meet the same host: the medians of each."""
    for _ in range(warmup):
        fn_a()
        fn_b()
    torch.cuda.synchronize()
    times = ([], [])
    for i in range(reps):
        for j in ((0, 1) if i % 2 == 0 else (1, 0)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            (fn_a, fn_b)[j]()
            end.record()
            end.synchronize()
            times[j].append(start.elapsed_time(end))
    return statistics.median(times[0]), statistics.median(times[1])


def device_events(fn, reps: int = 10, tries: int = 3):
    """The device-side events (kernels, copies, memsets) of ``reps`` calls
    of ``fn`` under ``torch.profiler``, from the first of up to ``tries``
    profiles that delivered any (a profile now and then delivers none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        if events:
            return events
    return []


def device_ms(fn, kernel: str, reps: int = 10):
    """(the named kernel's, all kernels') device time per call of ``fn``
    under ``torch.profiler``, or (None, None) where the profiler saw no
    device time."""
    events = device_events(fn, reps)
    own = sum(e.device_time_total for e in events if kernel in e.key)
    every = sum(e.device_time_total for e in events)
    if not every:
        return None, None
    return own / reps / 1e3, every / reps / 1e3


def kernels_per_call(fn, reps: int = 10):
    """Device operations (kernels, copies, memsets) per call of ``fn`` under
    ``torch.profiler``, or None where the profiler saw none."""
    n = sum(e.count for e in device_events(fn, reps))
    return n / reps if n else None


def ssu_update_without_sync(dev, buf, batch: int = B):
    """One ``ssu_update(..., backend="kernel")`` at full width (the largest
    table's reservoir; its column of a (batch, 26, 1) batch, strided as the
    emulator passes it, at period 2: batch / 2 candidates) under
    ``torch.cuda.set_sync_debug_mode("error")``: any host sync in it fails
    the run."""
    from repro_torch.core import trackers as trk
    from repro_torch.kernels import LAUNCHES
    rng = np.random.default_rng(4)
    sparse = torch.from_numpy(zipf_ids(rng, N_BIG, (batch, 26, 1))).to(dev)
    ids = sparse[:, 0, :]
    state = {"buf": buf, "gen": torch.Generator(device=dev).manual_seed(5)}
    trk.ssu_update(dict(state), ids, 2, backend="kernel")        # warm
    torch.cuda.synchronize()
    before = LAUNCHES["ssu_dedupe_evict"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        new = trk.ssu_update(state, ids, 2, backend="kernel")
    except RuntimeError as e:
        fail(f"ssu_update(backend='kernel') synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    launched = LAUNCHES["ssu_dedupe_evict"] - before
    n_kern = kernels_per_call(
        lambda: trk.ssu_update(dict(state), ids, 2, backend="kernel"))
    ok = bool((new["buf"][1:] >= new["buf"][:-1]).all())
    print(f"ssu_update(backend='kernel') at rn={buf.shape[0]}, ids "
          f"{tuple(ids.shape)}, period 2 ({ids.shape[0] // 2} candidates): "
          f"no host sync (sync debug mode "
          f"'error'); ssu_dedupe_evict launches={launched}; CUDA kernels "
          f"per update={n_kern} (profiler: the draw, the strided copy, the "
          f"kernel); output sorted={ok}")
    if launched != 1 or not ok:
        fail("ssu_update did not go through one ssu_dedupe_evict launch")


def print_embedding_times(name, kernel, library, kernel_name):
    """CUDA-event ms of the wrapper and the library call (in turns, the
    median of 101 each: both are host-bound), beside the kernel's own
    device ms from the profiler: the rest is host latency."""
    ms, lib_ms = time_pair_ms(kernel, library)
    own, every = device_ms(kernel, kernel_name)
    print(f"{name}: ms={ms:.4f} (CUDA events) kernel device ms="
          f"{'not measured' if own is None else f'{own:.4f}'} (profiler; "
          f"all the call's kernels "
          f"{'not measured' if every is None else f'{every:.4f}'}) "
          f"library_ms={lib_ms:.4f}")
    return ms, lib_ms


def embedding_launches():
    """A function giving the (forward, backward) embedding_bag launches
    since this call."""
    from repro_torch.kernels import LAUNCHES
    names = ("embedding_bag", "embedding_bag_backward")
    before = [LAUNCHES[n] for n in names]
    return lambda: tuple(LAUNCHES[n] - b for n, b in zip(names, before))


def phase_embedding_bags(dev, eb, ref, rng, gen):
    """The fused embedding kernels at the main path's shape: the 26
    unscaled Criteo-Kaggle tables (33,762,577 rows, d = 16, f32) and
    ``sparse`` (512, 26, 1) of Zipf ids, one launch each way.  Library
    yardstick: one ``F.embedding_bag`` (one ``embedding_dense_backward``)
    over a concatenated copy of the tables with offset ids, built outside
    the timed region and never used by the port."""
    import torch.nn.functional as F
    from repro_torch.configs.dlrm import DLRM_KAGGLE
    sizes = DLRM_KAGGLE.table_sizes
    T, hot = len(sizes), 1
    tables = [torch.rand((n, D), generator=gen, device=dev) - 0.5
              for n in sizes]
    sparse = torch.from_numpy(np.stack(
        [zipf_ids(rng, n, (B, hot)) for n in sizes], axis=1)).to(dev)
    launches = embedding_launches()
    got = eb.forward(tables, sparse)
    if launches() != (1, 0):
        fail(f"embedding_bag over {T} tables took {launches()} launches")
    want = ref.embedding_bags(tables, sparse)
    err = (got - want).abs().max().item()
    ok = err <= 1e-6 * max(want.abs().max().item(), 1.0)
    print(f"embedding_bag {T} tables {tuple(sparse.shape)} f32: one launch, "
          f"max_abs_err={err:.3e} tol=1e-6 ok={ok}")
    if not ok:
        fail(f"embedding_bag over {T} tables disagrees with its plain version")
    grad_out = torch.randn((B, T, D), generator=gen, device=dev) * 1e-2
    launches = embedding_launches()
    got_g = eb.backward(grad_out, sparse, list(sizes))
    if launches() != (0, 1):
        fail(f"embedding_bag_backward over {T} tables took {launches()} "
             f"launches")
    want_g = ref.embedding_bags_backward(grad_out, sparse, sizes)
    err_g = max((a - b).abs().max().item() for a, b in zip(got_g, want_g))
    scale_g = max(b.abs().max().item() for b in want_g)
    ok = err_g <= 1e-5 * max(scale_g, 1.0)
    print(f"embedding_bag_backward {T} tables: one launch, "
          f"max_abs_err={err_g:.3e} tol=1e-5 (relative to the largest "
          f"gradient) ok={ok}")
    if not ok:
        fail(f"embedding_bag_backward over {T} tables disagrees with its "
             f"plain version")
    del got, want, got_g, want_g

    starts = np.cumsum((0,) + tuple(sizes[:-1]))
    cat = torch.cat(tables)                       # the library's copy
    flat = (sparse.long() + torch.as_tensor(starts, device=dev)[None, :, None]
            ).reshape(-1)
    offsets = torch.arange(0, B * T * hot, hot, device=dev)
    n_rows = sum(sizes)
    rows = {}
    ms, lib_ms = print_embedding_times(
        f"embedding_bag {T} tables", lambda: eb.forward(tables, sparse),
        lambda: F.embedding_bag(flat, cat, offsets, mode="sum"),
        "embedding_bags_fwd")
    t_b, by = bound(B * T * hot * (D * 4 + 4) + B * T * D * 4,
                    ops=B * T * hot * D)
    rows["embedding_bag"] = dict(
        max_abs_err=err, ms=ms,
        plain_ms=time_ms(lambda: ref.embedding_bags(tables, sparse)),
        bound_ms=t_b, bound_by=by, library_ms=lib_ms)
    ms, lib_ms = print_embedding_times(
        f"embedding_bag_backward {T} tables",
        lambda: eb.backward(grad_out, sparse, sizes),
        lambda: torch.ops.aten.embedding_dense_backward(
            grad_out.reshape(-1, D), flat, n_rows, -1, False),
        "embedding_bags_bwd")
    t_b, by = bound(B * T * (D * 4 + hot * 4) + n_rows * D * 4,
                    ops=B * T * hot * D)
    rows["embedding_bag_backward"] = dict(
        max_abs_err=err_g, ms=ms,
        plain_ms=time_ms(lambda: ref.embedding_bags_backward(
            grad_out, sparse, sizes)),
        bound_ms=t_b, bound_by=by, library_ms=lib_ms)
    del tables, cat
    torch.cuda.empty_cache()
    return rows


def phase_wide_contracts(dev, eb, ts, ref, rng, gen):
    """The kernels' widened contracts at full width, off the main path:
    ``tracker_select`` past a team's ``TEAM_SEG`` rows (the largest
    table's counters in segments of 65,536: a block a segment, selecting
    in device memory), ``embedding_bags`` over the 26 unscaled tables as
    rows of 3 f32 (12-byte rows: the element path) and over 130 tables
    (the 26, five times: groups of 64, three launches each way).  Each
    equals its plain version (``torch.equal``; the backward within 1e-5
    of the largest gradient, atomic adds) and is timed beside it."""
    from repro_torch.configs.dlrm import DLRM_KAGGLE
    from repro_torch.kernels import LAUNCHES
    seg, k = 65_536, 64
    counts = torch.from_numpy(np.minimum(rng.zipf(1.2, N_BIG) - 1, 1000)
                              .astype(np.int32)).to(dev)
    pend_np = zipf_ids(rng, N_BIG, (2048,))
    pend_np[:64] = -5                       # out of range: match nothing
    pend = torch.from_numpy(pend_np).to(dev)
    got, want = (f(counts, pend, k, seg_size=seg) for f in
                 (ts.tracker_select, ref.tracker_select))
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    t_b, _ = bound(N_BIG * 4 * 2 + -(-N_BIG // seg) * k * 4)
    print(f"tracker_select wide path (seg {seg} > TEAM_SEG {ts.TEAM_SEG}, "
          f"{-(-N_BIG // seg)} segments, k={k}, 2048 pending): "
          f"torch.equal={equal} ms="
          f"{time_ms(lambda: ts.tracker_select(counts, pend, k, seg_size=seg)):.4f}"
          f" plain_ms="
          f"{time_ms(lambda: ref.tracker_select(counts, pend, k, seg_size=seg)):.4f}"
          f" bound_ms={t_b:.5f}")
    if not equal:
        fail("tracker_select's wide path disagrees with its plain version")
    del counts, got, want

    sizes = DLRM_KAGGLE.table_sizes
    sparse = torch.from_numpy(np.stack(
        [zipf_ids(rng, n, (B, 1)) for n in sizes], axis=1)).to(dev)
    for name, d, times in (("26 tables, 12-byte rows (element path)", 3, 1),
                           ("130 tables (3 groups)", D, 5)):
        tables = [torch.rand((n, d), generator=gen, device=dev) - 0.5
                  for n in sizes] * times
        sp = sparse.repeat(1, times, 1).contiguous()
        T = len(tables)
        before = (LAUNCHES["embedding_bag"], LAUNCHES["embedding_bag_backward"])
        out = eb.forward(tables, sp)
        grad_out = torch.randn((B, T, d), generator=gen, device=dev) * 1e-2
        grads = eb.backward(grad_out, sp, [t.shape[0] for t in tables])
        launched = (LAUNCHES["embedding_bag"] - before[0],
                    LAUNCHES["embedding_bag_backward"] - before[1])
        equal = torch.equal(out, ref.embedding_bags(tables, sp))
        want = ref.embedding_bags_backward(grad_out, sp,
                                           [t.shape[0] for t in tables])
        err = max((a - b).abs().max().item() for a, b in zip(grads, want))
        scale = max(b.abs().max().item() for b in want)
        ok = equal and err <= 1e-5 * max(scale, 1.0)
        rows = [t.shape[0] for t in tables]
        t_f, _ = bound(B * T * (d * 4 + 4) + B * T * d * 4, ops=B * T * d)
        t_g, _ = bound(B * T * (d * 4 + 4) + sum(rows) * d * 4,
                       ops=B * T * d)
        print(f"embedding_bags {name}, d={d}, sparse {tuple(sp.shape)}: "
              f"bound_ms={t_f:.5f} backward bound_ms={t_g:.5f} (bytes); "
              f"launches (forward, backward)={launched} forward "
              f"torch.equal={equal} backward max_abs_err={err:.3e} "
              f"(tol 1e-5 of the largest gradient) ms="
              f"{time_ms(lambda: eb.forward(tables, sp)):.4f} plain_ms="
              f"{time_ms(lambda: ref.embedding_bags(tables, sp)):.4f} "
              f"backward ms="
              f"{time_ms(lambda: eb.backward(grad_out, sp, rows)):.4f} "
              f"plain_ms="
              f"{time_ms(lambda: ref.embedding_bags_backward(grad_out, sp, rows)):.4f}")
        if not ok or launched != (-(-T // eb.GROUP),) * 2:
            fail(f"embedding_bags over {name} disagrees with its plain "
                 f"version or took {launched} launches")
        del tables, out, grads, want
        torch.cuda.empty_cache()


def phase_kernels(dev, eb, ts, sd, ref):
    """Each kernel vs its plain version at the path's shapes."""
    import torch.nn.functional as F
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    # ---- embedding_bag, one table (T = 1, the largest): forward (f32,
    # bf16; hot 1 and 3) and backward, against the plain version ----
    table = torch.rand((N_BIG, D), generator=gen, device=dev) - 0.5
    for hot in (1, 3):
        idx = torch.from_numpy(zipf_ids(rng, N_BIG, (B, hot))).to(dev)
        sp = idx[:, None]
        for dtype, tol in ((torch.float32, 1e-6), (torch.bfloat16, 2e-2)):
            tab = table.to(dtype)
            got = eb.forward([tab], sp)[:, 0].float()
            want = ref.embedding_bag(tab, idx).float()
            err = (got - want).abs().max().item()
            ok = err <= tol * max(want.abs().max().item(), 1.0)
            print(f"embedding_bag one table hot={hot} {str(dtype)[6:]}: "
                  f"max_abs_err={err:.3e} tol={tol:g} ok={ok}")
            if not ok:
                fail("embedding_bag disagrees with its plain version")
            if hot == 1 and dtype == torch.float32:
                flat = idx.reshape(-1).long()
                offsets = torch.arange(0, B * hot, hot, device=dev)
                print_embedding_times(
                    "embedding_bag one table hot=1 f32",
                    lambda: eb.forward([tab], sp),
                    lambda: F.embedding_bag(flat, tab, offsets, mode="sum"),
                    "embedding_bags_fwd")
        grad_out = (torch.randn((B, 1, D), generator=gen, device=dev) * 1e-2)
        got = eb.backward(grad_out, sp, [N_BIG])[0]
        want = ref.embedding_bag_backward(grad_out[:, 0], idx, N_BIG)
        err = (got - want).abs().max().item()
        # atomic adds land in run-dependent order on repeated (Zipf) ids:
        # f32 rounding of sums of up to B*hot terms
        ok = err <= 1e-5 * max(want.abs().max().item(), 1.0)
        print(f"embedding_bag_backward one table hot={hot}: "
              f"max_abs_err={err:.3e} tol=1e-5 (relative to the largest "
              f"gradient) ok={ok}")
        if not ok:
            fail("embedding_bag backward disagrees with its plain version")
        if hot == 1:
            flat = idx.reshape(-1).long()
            print_embedding_times(
                "embedding_bag_backward one table hot=1",
                lambda: eb.backward(grad_out, sp, [N_BIG]),
                lambda: torch.ops.aten.embedding_dense_backward(
                    grad_out[:, 0], flat, N_BIG, -1, False),
                "embedding_bags_bwd")
    del table, tab
    torch.cuda.empty_cache()
    rows.update(phase_embedding_bags(dev, eb, ref, rng, gen))

    # ---- tracker_select: Zipf-skewed counters (massive ties), seg 512, k 64
    counts = torch.from_numpy(np.minimum(rng.zipf(1.2, N_BIG) - 1, 1000)
                              .astype(np.int32)).to(dev)
    pend_np = zipf_ids(rng, N_BIG, (2048,))
    pend_np[:64] = -5                       # out of range: match nothing
    pend_np[64:128] = N_BIG + 7
    cases = {"no pending": torch.zeros(0, dtype=torch.int32, device=dev),
             "2048 pending": torch.from_numpy(pend_np).to(dev)}
    seg, k = 512, 64
    err = 0
    for name, pend in cases.items():
        ids, nc = ts.tracker_select(counts, pend, k, seg_size=seg)
        rids, rnc = ref.tracker_select(counts, pend, k, seg_size=seg)
        if ids.shape != rids.shape or nc.shape != rnc.shape:
            fail("tracker_select output shapes differ from its plain version")
        diff = max(int((ids.long() - rids.long()).abs().max()),
                   int((nc.long() - rnc.long()).abs().max()))
        err = max(err, diff)
        print(f"tracker_select {name}: max_abs_err={diff} (ids and counts)")
        if diff:
            fail("tracker_select disagrees with its plain version")
    pend = cases["no pending"]            # the emulator's call: counts folded
    n_seg = -(-N_BIG // seg)
    t_b, by = bound(N_BIG * 4 * 2 + n_seg * k * 4)
    rows["tracker_select"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: ts.tracker_select(counts, pend, k, seg_size=seg)),
        plain_ms=time_ms(lambda: ref.tracker_select(counts, pend, k,
                                                    seg_size=seg)),
        bound_ms=t_b, bound_by=by, library_ms=None)
    # a yardstick, not the same function (so library_ms stays None):
    # torch.topk over the padded (n_seg, seg) view picks k per segment but
    # promises no tie order and clears nothing
    view = torch.full((n_seg * seg,), -1, dtype=torch.int32, device=dev)
    view[:N_BIG] = counts
    view = view.view(n_seg, seg)
    topk_ms = time_ms(lambda: torch.topk(view, k, dim=1))
    print(f"tracker_select yardstick: torch.topk over the ({n_seg}, {seg}) "
          f"view ms={topk_ms:.4f} (selection only: no tie order, no "
          f"clearing)")

    def select():
        return ts.tracker_select(counts, pend, k, seg_size=seg)

    own, _ = device_ms(select, "tracker_select_kernel")
    print(f"tracker_select ({n_seg}, {seg}) k={k}: ms="
          f"{rows['tracker_select']['ms']:.4f} (CUDA events, one call) "
          f"run_ms={run_ms(select):.4f} (100 calls back to back) kernel "
          f"device ms={'not measured' if own is None else f'{own:.4f}'} "
          f"(profiler) bound_ms={t_b:.5f}; CUDA kernels per call="
          f"{kernels_per_call(select)} (profiler)")
    del counts, view

    # ---- ssu_dedupe_evict: rn = 0.125 * N, nc = 256 ----
    rn, nc = int(0.125 * N_BIG), 256
    EMPTY = ref.EMPTY

    def reservoir(live):
        buf = np.full(rn, EMPTY, np.int32)
        buf[:live] = np.sort(rng.choice(N_BIG, size=live, replace=False))
        return buf

    def candidates(buf, live):
        """Raw, as ``ssu_update`` passes them: Zipf ids in draw order,
        repeats and all, a quarter of them already in the reservoir."""
        c = zipf_ids(rng, N_BIG, (nc,))
        c[: nc // 4] = rng.choice(buf[:live], size=nc // 4)  # already present
        return c

    # The bytes each case needs.  Without overflow the answer is the merge
    # of the lb live reservoir ids with the live candidates, EMPTY-padded:
    # lb*4 + nc*4 read, rn*4 written; the scores are never read.  With
    # overflow the live slots' scores ((lb+lc)*4) are read as well.
    timed, err = {}, 0
    for name, live, tied in (("half full", rn // 2, False),
                             ("full (overflow)", rn, False),
                             ("full (overflow, tied scores)", rn, True)):
        buf_np = reservoir(live)
        cand_np = candidates(buf_np, live)
        lc = np.setdiff1d(cand_np, buf_np).size      # live, deduped
        overflow = live + lc > rn
        nbytes = live * 4 + nc * 4 + rn * 4 + (live + lc) * 4 * overflow
        buf = torch.from_numpy(buf_np).to(dev)
        cand = torch.from_numpy(cand_np).to(dev)
        scores = torch.rand(rn + nc, generator=gen, device=dev)
        if tied:
            scores = torch.floor(scores * 64) / 64
        got = sd.ssu_dedupe_evict(buf, cand, scores)
        want = ref.ssu_dedupe_evict(buf, cand, scores)
        diff = int((got.long() - want.long()).abs().max())
        err = max(err, diff)
        print(f"ssu_dedupe_evict {name}: live={live + lc} rn={rn} "
              f"overflow={overflow} max_abs_err={diff} "
              f"(differing slots: {int((got != want).sum())})")
        if diff:
            fail("ssu_dedupe_evict disagrees with its plain version")
        timed.setdefault(overflow, (buf, cand, scores, nbytes))
    for overflow, (buf, cand, scores, nbytes) in sorted(timed.items()):
        t_b, by = bound(nbytes)
        row = dict(
            max_abs_err=err,
            ms=time_ms(lambda: sd.ssu_dedupe_evict(buf, cand, scores)),
            plain_ms=time_ms(lambda: ref.ssu_dedupe_evict(buf, cand, scores)),
            bound_ms=t_b, bound_by=by, library_ms=None)
        def update():
            return sd.ssu_dedupe_evict(buf, cand, scores)

        n_kern = kernels_per_call(update)
        own, _ = device_ms(update, "ssu_kernel")
        print(f"ssu_dedupe_evict timed, overflow={overflow}: {nbytes} bytes "
              f"needed; ms={row['ms']:.4f} (CUDA events, one call) run_ms="
              f"{run_ms(update):.4f} (100 calls back to back) kernel device "
              f"ms={'not measured' if own is None else f'{own:.4f}'} "
              f"(profiler) plain_ms={row['plain_ms']:.4f} bound_ms="
              f"{t_b:.5f}; CUDA kernels per call={n_kern} (profiler)")
        if n_kern is None:
            fail("the profiler saw no device work in ssu_dedupe_evict")
        if not overflow:                    # the path's steady state
            if n_kern > 2:
                fail(f"ssu_dedupe_evict issued {n_kern} CUDA kernels in the "
                     f"steady state (at most 2)")
            rows["ssu_dedupe_evict"] = row
    # past one tile (TILE = 8,192 candidates), as LM training (8 x 4,096
    # tokens at period 2) or a DLRM batch above 16,384 samples sends them:
    # sorted a tile at a time and ranked across tiles in the same launch
    for n_cand in (2 * sd.TILE, 8 * sd.TILE):
        for name, live in (("half full", rn // 2), ("full (overflow)", rn)):
            buf_np = reservoir(live)
            cand_np = zipf_ids(rng, N_BIG, (n_cand,))
            cand_np[: n_cand // 4] = rng.choice(buf_np[:live], size=n_cand // 4)
            lc = np.setdiff1d(cand_np, buf_np).size
            overflow = live + lc > rn
            nbytes = (live * 4 + n_cand * 4 + rn * 4 +
                      (live + lc) * 4 * overflow)
            buf = torch.from_numpy(buf_np).to(dev)
            cand = torch.from_numpy(cand_np).to(dev)
            scores = torch.rand(rn + n_cand, generator=gen, device=dev)

            def update():
                return sd.ssu_dedupe_evict(buf, cand, scores)

            got = update()
            want = ref.ssu_dedupe_evict(buf, cand, scores)
            equal = torch.equal(got, want)
            t_b, _ = bound(nbytes)
            ms = time_ms(update)
            plain_ms = time_ms(lambda: ref.ssu_dedupe_evict(buf, cand, scores))
            print(f"ssu_dedupe_evict nc={n_cand} ({-(-n_cand // sd.TILE)} "
                  f"tiles) {name}: live={live + lc} rn={rn} "
                  f"overflow={overflow} torch.equal={equal} (differing "
                  f"slots: {int((got != want).sum())}); {nbytes} bytes "
                  f"needed; ms={ms:.4f} (CUDA events, one call) "
                  f"plain_ms={plain_ms:.4f} bound_ms={t_b:.5f}; CUDA kernels "
                  f"per call={kernels_per_call(update)} (profiler)")
            if not equal:
                fail(f"ssu_dedupe_evict with {n_cand} candidates disagrees "
                     f"with its plain version")
    ssu_update_without_sync(dev, timed[False][0])
    ssu_update_without_sync(dev, timed[False][0], batch=4 * sd.TILE)
    del timed, buf, cand, scores
    torch.cuda.empty_cache()
    phase_wide_contracts(dev, eb, ts, ref, np.random.default_rng(5),
                         torch.Generator(device=dev).manual_seed(5))
    for name, r in rows.items():
        print(f"{name}: ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']}) "
              f"library_ms={r['library_ms']}")
    return rows


def phase_row_hash(dev, rh, ref):
    """``row_hash`` vs its plain version, bit for bit, at the path's
    shapes; timed on the largest table with its f32 accumulator."""
    gen = torch.Generator(device=dev).manual_seed(1)
    table = torch.rand((N_BIG, D), generator=gen, device=dev) - 0.5
    acc = torch.rand(N_BIG, generator=gen, device=dev)
    cases = {
        "largest table f32": (table, acc),
        "largest table bf16": (table.to(torch.bfloat16), acc),
        "ragged d=9 f32": (torch.rand((N_RAGGED, 9), generator=gen,
                                      device=dev), acc[:N_RAGGED]),
        "no rows": (table[:0], acc[:0]),
        "zero-byte rows": (table[:1000, :0], acc[:1000, None][:, :0]),
    }
    worst = 0
    for name, (values, accs) in cases.items():
        got = rh.row_hash(values, accs)
        want = ref.row_hash(values, accs)
        if got.shape != want.shape or got.dtype != torch.int64:
            fail(f"row_hash {name}: shape/dtype differ from the plain version")
        differing = int((got != want).sum())
        if differing:
            # |a - b| of the uint64 bits, exact in Python integers
            a = got.cpu().numpy().view(np.uint64).astype(object)
            b = want.cpu().numpy().view(np.uint64).astype(object)
            worst = max(worst, max(abs(int(x) - int(y))
                                   for x, y in zip(a, b)))
        print(f"row_hash {name}: rows={values.shape[0]} "
              f"row_bytes={rh.row_bytes(values)}+{rh.row_bytes(accs)} "
              f"differing_words={differing}")
        if differing:
            fail("row_hash disagrees with its plain version")
    del cases
    row_bytes = rh.row_bytes(table) + rh.row_bytes(acc)
    t_b, by = bound(N_BIG * (row_bytes + 8))
    row = dict(max_abs_err=worst,
               ms=time_ms(lambda: rh.row_hash(table, acc)),
               plain_ms=time_ms(lambda: ref.row_hash(table, acc)),
               bound_ms=t_b, bound_by=by, library_ms=None)
    bf = table.to(torch.bfloat16)
    bf_ms = time_ms(lambda: rh.row_hash(bf, acc))
    t_bf, _ = bound(N_BIG * (rh.row_bytes(bf) + 4 + 8))
    print(f"row_hash: ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
          f"bound_ms={t_b:.5f} ({by}); bf16 copy ms={bf_ms:.4f} "
          f"bound_ms={t_bf:.5f}")
    return row


def phase_main_path(dev, kernels, cfg, num_samples=40_000):
    """Full-width Criteo-Kaggle emulation in three modes, on the flat
    store and then on the sharded writer fleet."""
    from repro_torch.core import (CPRManager, Emulator, FailureInjector,
                                  ShardedCheckpointWriter, SystemParams)
    from repro_torch.data.synthetic import ClickLogDataset
    t0 = time.perf_counter()
    ds = ClickLogDataset(cfg.table_sizes, num_samples=num_samples, seed=3)
    print(f"dataset: {cfg.name}, {cfg.total_emb_rows():,} rows, "
          f"{len(ds):,} samples ({time.perf_counter() - t0:.1f} s)")
    drives = {"full": {"embedding_bag", "embedding_bag_backward"},
              "cpr-mfu": {"embedding_bag", "embedding_bag_backward",
                          "tracker_select"},
              "cpr-ssu": {"embedding_bag", "embedding_bag_backward",
                          "ssu_dedupe_evict"}}
    (_, _), (ev0, ev1) = ds.eval_split(0.1)       # Emulator's eval_frac
    n_eval = sum(1 for _ in ds.batches(4096, ev0, ev1))
    totals = {name: 0 for name in kernels.LAUNCHES}
    for store, fleet, steps in (("flat", {}, STEPS_FLAT),
                                ("fleet", FLEET, STEPS_FLEET)):
        for mode, must in drives.items():
            must = must | ({"row_hash"} if fleet else set())
            p = SystemParams()
            mgr = CPRManager(mode, p, cfg.table_sizes, target_pls=0.1,
                             tracker_backend="kernel", device=dev, **fleet)
            inj = FailureInjector(2, 0.25, p.N_emb, p.T_total, seed=11)
            emu = Emulator(cfg, ds, mgr, inj, batch_size=B, device=dev)
            kernels.reset_launches()
            t0 = time.perf_counter()
            res = emu.run(max_steps=steps)
            wall = time.perf_counter() - t0
            counts = dict(kernels.LAUNCHES)
            for name, n in counts.items():
                totals[name] += n
            rep = res.report
            steady = statistics.median(emu.step_seconds[5:]) * 1e3
            print(f"[{store}] {res.summary()}")
            print(f"  {store} {mode}: steps={res.n_steps} "
                  f"steady_ms_per_step={steady:.3f} wall_s={wall:.1f} "
                  f"final_loss={res.final_loss:.5f} "
                  f"bytes_written={rep['bytes_written']} "
                  f"save_blocked_s={rep['overheads']['save_blocked_s']:.3f} "
                  f"delta_rows_skipped={rep.get('delta_rows_skipped')} "
                  f"delta_bytes_skipped={rep.get('delta_bytes_skipped')} "
                  f"launches={json.dumps(counts)}")
            missing = [n for n in must if counts[n] == 0]
            if missing:
                fail(f"{store} {mode}: kernels {missing} were never launched")
            # one fused launch each way per train step, one forward per
            # evaluation batch
            per_step = ((counts["embedding_bag"] - n_eval) / res.n_steps,
                        counts["embedding_bag_backward"] / res.n_steps)
            print(f"  {store} {mode}: embedding_bag launches per train step "
                  f"(forward, backward) = {per_step}, plus {n_eval} for "
                  f"evaluation")
            if per_step != (1, 1):
                fail(f"{store} {mode}: embedding_bag launched {per_step} "
                     f"times per train step, not once each way")
            if not math.isfinite(res.final_loss) or not math.isfinite(res.auc):
                fail(f"{store} {mode}: loss or AUC is not finite")
            if fleet and not (rep["sharded_save"] and
                              isinstance(mgr.store, ShardedCheckpointWriter)
                              and rep["hash_backend"] == "kernel"):
                fail(f"fleet {mode}: the run did not go through the fleet")
            if mode != "full":
                restores = [h for h in mgr.history if h["event"] == "failure"]
                if mgr.effective_mode != mode or not restores:
                    fail(f"{store} {mode}: no partial-recovery restore "
                         f"happened")
            del emu, mgr
            torch.cuda.empty_cache()
    return totals


def _pipe_writer_probe(*args):
    """Pipe writer entry point for this run: the transport's own, then a
    report, from inside the writer process, of whether it ever created a
    CUDA context."""
    from repro_torch.core import transport
    try:
        transport._pipe_worker_main(*args)
    finally:
        probe = Path(os.environ[PROBE_ENV]) / f"writer-{os.getpid()}.txt"
        probe.write_text(str(torch.cuda.is_initialized()))


def phase_agreement(dev):
    """The scaled config on the card vs on the CPU, same parameters, on the
    flat store and through the fleet over pipe and socket; then a disk
    round trip of the fleet and the writer processes' CUDA state."""
    from repro_torch.configs.dlrm import DLRM_KAGGLE, scaled
    from repro_torch.core import (CPRManager, Emulator, FailureInjector,
                                  SystemParams, load_latest_auto, transport)
    from repro_torch.data.synthetic import ClickLogDataset
    from repro_torch.models.dlrm import init_dlrm, params_to_numpy
    cfg = scaled(DLRM_KAGGLE, 2000)
    ds = ClickLogDataset(cfg.table_sizes, num_samples=8000, seed=3)
    init = params_to_numpy(init_dlrm(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    shutil.rmtree(SCRATCH, ignore_errors=True)
    (SCRATCH / "probe").mkdir(parents=True)
    os.environ[PROBE_ENV] = str(SCRATCH / "probe")
    transport._pipe_worker_main = _pipe_writer_probe

    def run(device, **kw):
        p = SystemParams()
        mgr = CPRManager("cpr-mfu", p, cfg.table_sizes, target_pls=0.1,
                         tracker_backend="kernel", device=device, **kw)
        inj = FailureInjector(2, 0.25, p.N_emb, p.T_total, seed=11)
        res = Emulator(cfg, ds, mgr, inj, batch_size=256, device=device,
                       init_params=init).run()
        return res, mgr

    fleet = {"sharded_save": True, "delta_saves": True}
    for name, kw in (("flat", {}),
                     ("fleet pipe", dict(fleet, transport="pipe")),
                     ("fleet socket", dict(fleet, transport="socket"))):
        t0 = time.perf_counter()
        card, _ = run(dev, **kw, **({"hash_backend": "kernel"} if kw else {}))
        cpu, _ = run("cpu", **kw)            # host ledger on the CPU
        a, b = card.report, cpu.report
        same = all(a["overheads"][k] == b["overheads"][k]
                   for k in ("save", "load", "lost", "resched"))
        for k in ("measured_pls", "bytes_written", "delta_rows_skipped",
                  "delta_bytes_skipped", "dropped_bytes"):
            same &= a.get(k) == b.get(k)
        gap = abs(card.auc - cpu.auc)
        print(f"agreement (scaled, cpr-mfu, {name}): card auc={card.auc:.6f} "
              f"cpu auc={cpu.auc:.6f} gap={gap:.2e} "
              f"bytes_written={a['bytes_written']} "
              f"delta_rows_skipped={a.get('delta_rows_skipped')} "
              f"charges/pls/bytes/deltas identical={same} "
              f"({time.perf_counter() - t0:.1f} s)")
        if not same or gap > 5e-3:
            fail(f"{name}: the card's run disagrees with the CPU path")

    # the fleet's writer on the card (pinned save_full snapshots, device
    # delta skip, in-place restore) against the same writer on the CPU
    from repro_torch.core import EmbShardSpec, ShardedCheckpointWriter
    spec = EmbShardSpec(cfg.table_sizes, 8)
    rng = np.random.default_rng(7)
    tabs = [np.asarray(t) for t in init["tables"]]
    accs = [rng.random(len(t)).astype(np.float32) for t in tabs]
    views = {}
    for device, hb in ((dev, "kernel"), ("cpu", "host")):
        t = [torch.tensor(x, device=device) for x in tabs]
        a = [torch.tensor(x, device=device) for x in accs]
        w = ShardedCheckpointWriter(t, a, spec, hash_backend=hb)
        w.save_full([x + 1 for x in t], [x + 1 for x in a], step=1)
        big = max(range(len(t)), key=lambda i: len(t[i]))
        rows = torch.arange(0, len(t[big]), 3, device=device)
        vals = t[big][rows] + 1                     # equal to the full: skip
        vals[::2] += 1                              # half of them changed
        w.save_rows(big, rows, vals, a[big][rows] + 1, step=2)
        w.fence()
        w.restore_shards(t, a, [1, 5])
        views[str(device)] = ([x.cpu().numpy() for x in t + a],
                              w.restore_all()[:2], w.bytes_written,
                              w.delta_rows_skipped, w.delta_bytes_skipped)
        w.close()
    card, cpu = views[str(dev)], views["cpu"]
    same = (card[2:] == cpu[2:] and
            all(x.tobytes() == y.tobytes() for x, y in zip(card[0], cpu[0]))
            and all(x.tobytes() == y.tobytes() for x, y in
                    zip(card[1][0] + card[1][1], cpu[1][0] + cpu[1][1])))
    print(f"fleet writer (scaled, inproc): card vs CPU images, restores, "
          f"bytes_written={card[2]} delta_rows_skipped={card[3]} "
          f"identical={same}")
    if not same:
        fail("the fleet's writer on the card disagrees with the CPU's")

    # a disk directory through pipe: the reload equals the writers' image
    # at their final fence, byte for byte
    root = str(SCRATCH / "ckpt")
    p = SystemParams()
    mgr = CPRManager("cpr-mfu", p, cfg.table_sizes, target_pls=0.1,
                     tracker_backend="kernel", device=dev, directory=root,
                     transport="pipe", hash_backend="kernel", **fleet)
    fenced = {}
    close = mgr.close

    def close_keeping_the_fenced_image():
        mgr.fence()
        fenced["image"] = mgr.store.restore_all()
        close()

    mgr.close = close_keeping_the_fenced_image
    Emulator(cfg, ds, mgr, FailureInjector(2, 0.25, p.N_emb, p.T_total,
                                           seed=11),
             batch_size=256, device=dev, init_params=init).run()
    base_t = [np.asarray(t) for t in init["tables"]]
    base_a = [np.zeros(len(t), np.float32) for t in base_t]
    got_t, got_a, _ = load_latest_auto(root, base_t, base_a,
                                       mgr.spec).restore_all()
    want_t, want_a, _ = fenced["image"]
    same = all(x.tobytes() == y.tobytes() for x, y in
               zip(got_t + got_a, want_t + want_a))
    print(f"disk round trip (scaled, cpr-mfu, pipe, {mgr.store.cycle} "
          f"stamped cycles): reload equals the fenced image byte for "
          f"byte={same}")
    if not same:
        fail("load_latest_auto disagrees with the writers' fenced image")
    probes = sorted((SCRATCH / "probe").glob("writer-*.txt"))
    states = [f.read_text() for f in probes]
    print(f"pipe writer processes: {len(states)} reported; CUDA context "
          f"created in {states.count('True')}")
    if len(states) < 2 * p.N_emb or any(x != "False" for x in states):
        fail("a pipe writer process created a CUDA context (or did not "
             "report)")
    shutil.rmtree(SCRATCH, ignore_errors=True)


def _server_probe(*args):
    """Socket server entry point for this run: the shard server's own,
    beside a thread that reports, from inside the server process, whether
    it ever created a CUDA context.  A server serves until it is killed,
    so the report is rewritten while it serves."""
    from repro_torch.launch import shard_server
    probe = Path(os.environ[PROBE_ENV]) / f"server-{os.getpid()}.txt"

    def report():
        tmp = probe.with_suffix(".tmp")
        while True:                     # replaced whole: never read torn
            tmp.write_text(str(torch.cuda.is_initialized()))
            os.replace(tmp, probe)
            time.sleep(0.05)

    threading.Thread(target=report, daemon=True).start()
    shard_server.spawned_server_main(*args)


def available_ram() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return 0


def phase_fleet_figures(dev, kernels, cfg):
    """The port's fleet figures on the card (phase 6)."""
    import tempfile

    from benchmarks_torch import common
    from benchmarks_torch import fig15_sharded_save as fig15
    from benchmarks_torch import fig16_reshard as fig16
    from benchmarks_torch import fig17_wire as fig17
    from benchmarks_torch import run as harness
    from repro_torch.core import transport
    from repro_torch.launch import shard_server
    label = common.device_label(dev)
    tmp = tempfile.gettempdir()
    free, ram = shutil.disk_usage(tmp).free, available_ram()
    print(f"fleet figures: {free / 1e9:.1f} GB free under {tmp}, "
          f"{ram / 1e9:.1f} GB of host memory available")
    if free < FLEET_DISK_BYTES or ram < FLEET_RAM_BYTES:
        fail(f"the fleet figures need {FLEET_DISK_BYTES / 1e9:.0f} GB of "
             f"disk under {tmp} and {FLEET_RAM_BYTES / 1e9:.0f} GB of host "
             f"memory")
    probes = SCRATCH / "probe-fleet"
    shutil.rmtree(probes, ignore_errors=True)
    probes.mkdir(parents=True)
    os.environ[PROBE_ENV] = str(probes)
    transport._pipe_worker_main = _pipe_writer_probe
    shard_server.spawned_server_main = _server_probe
    fast = harness.FAST_OVERRIDES
    top = max(cfg.table_sizes)           # a max_rows that scales nothing
    runs = (
        (f"fig15 (full width, {cfg.total_emb_rows():,} rows)", fig15,
         dict(FIG15_FULL, max_rows=top)),
        ("fig15 --fast, 2 shards", fig15, dict(fast["fig15"], **FIG15_FLEETS)),
        ("fig16 --fast, one transition", fig16,
         dict(fast["fig16"], **FIG16_CUT)),
        (f"fig17 --fast, 2 shards, hash_kernel at {N_BIG:,} rows", fig17,
         dict(fast["fig17"], hash_rows=N_BIG, **FIG17_CUT)))
    kernels.reset_launches()
    t_phase = time.perf_counter()
    rows = {}
    for i, (name, mod, kw) in enumerate(runs):
        t0 = time.perf_counter()
        before = dict(kernels.LAUNCHES)
        rows[name] = mod.run(device=dev, **kw)
        for row in rows[name]:
            print(f"{name} {json.dumps({**row, 'device': label})}")
        print(f"{name}: launches {json.dumps(launches_since(kernels, before))}"
              f" ({time.perf_counter() - t0:.1f} s)")
        if i == 0:
            # the same delta saves on the CPU (the plain hash), from the
            # same numpy draw: equal rows
            t0 = time.perf_counter()
            card = [r for r in rows[name] if r["kind"] == "delta_save"]
            cpu = mod.run(**dict(kw, kinds=("delta_save",)), device="cpu")
            print(f"{name} delta_save on the CPU {json.dumps(cpu)} equal to "
                  f"the card's={card == cpu} "
                  f"({time.perf_counter() - t0:.1f} s)")
            if card != cpu:
                fail("fig15's full-width delta saves differ between the card "
                     "and the CPU")
    common.clear_fleet_state()
    launches = dict(kernels.LAUNCHES)
    print(f"fleet figures: row_hash launches {launches['row_hash']} "
          f"({time.perf_counter() - t_phase:.1f} s)")
    for name, out in rows.items():
        for row in out:
            bad = [k for k in FLEET_AUDITS if k in row and row[k] is not True]
            if bad:
                fail(f"{name} {row['kind']}: audit {bad} false on the card")
            if row.get("unchanged_resave_bytes", 0) != 0:
                fail(f"{name}: an unchanged re-save shipped "
                     f"{row['unchanged_resave_bytes']} bytes")
    if launches["row_hash"] == 0:
        fail("the fleet figures never launched row_hash")

    states = {f.name: f.read_text() for f in probes.glob("*.txt")}
    writers = sum(n.startswith("writer-") for n in states)
    servers = sum(n.startswith("server-") for n in states)
    cuda = sorted(f"{n}: {v!r}" for n, v in states.items() if v != "False")
    alive = [n for n in states if os.path.exists(f"/proc/{n[:-4].split('-')[1]}")]
    print(f"fleet figures: {writers} pipe writer and {servers} socket server "
          f"processes reported ({len(alive)} still running); a CUDA context "
          f"in {len(cuda)}")
    if not writers or not servers or cuda:
        fail(f"a fleet process created a CUDA context (or none reported): "
             f"{cuda}")
    shutil.rmtree(probes, ignore_errors=True)
    return launches["row_hash"]


def launches_since(kernels, before):
    return {n: kernels.LAUNCHES[n] - before[n] for n in kernels.LAUNCHES}


def phase_harness(dev, kernels, cfg):
    """The port's benchmark harness on the card (phase 5)."""
    from benchmarks_torch import common
    from benchmarks_torch import fig7_overhead as fig7
    from benchmarks_torch import fig14_async_save as fig14
    from benchmarks_torch import run as harness
    from benchmarks_torch import table1_trackers as table1
    from repro_torch.models.dlrm import init_dlrm, params_to_numpy
    label = common.device_label(dev)
    emb = {"embedding_bag", "embedding_bag_backward"}
    uses = {"cpr-mfu": {"tracker_select"}, "cpr-ssu": {"ssu_dedupe_evict"}}

    # (a) fig7, Kaggle at full width, every mode on the kernel backend
    t0 = time.perf_counter()
    top = max(cfg.table_sizes)           # a max_rows that scales nothing
    if common.get_dataset("kaggle", 3, top)[0] != cfg:
        fail("the harness does not give the published Kaggle config")
    kernels.reset_launches()
    rows = []
    for mode in fig7.MODES:
        before = dict(kernels.LAUNCHES)
        (row,) = fig7.run(datasets=("kaggle",), modes=(mode,), device=dev,
                          tracker_backend="kernel", max_rows=top,
                          max_steps=STEPS_FLAT)
        counts = launches_since(kernels, before)
        rows.append(row)
        print(f"fig7 (full width, {cfg.total_emb_rows():,} rows, "
              f"{STEPS_FLAT} steps) {json.dumps({**row, 'device': label})}")
        print(f"  launches: {json.dumps(counts)}")
        missing = sorted(n for n in emb | uses.get(mode, set())
                         if counts[n] == 0)
        if missing:
            fail(f"fig7 {mode} at full width never launched {missing}")
        if not math.isfinite(row["auc"]):
            fail(f"fig7 {mode} at full width: AUC is not finite")
        # every failure reloads: everything under full recovery, only the
        # failed shards (a smaller charge) under the partial modes
        full_load = rows[0]["load_h"]
        if not (full_load > 0 and (mode == "full" or
                                   row["load_h"] < full_load)):
            fail(f"fig7 {mode} at full width: load {row['load_h']} h (full: "
                 f"{full_load} h) says the run did not recover as the mode "
                 f"does")
    launches = dict(kernels.LAUNCHES)
    for row in fig7.derived(rows):
        print(f"fig7 (full width) {json.dumps({**row, 'device': label})}")
    print(f"fig7 (full width): launches of the six runs "
          f"{json.dumps(launches)} ({time.perf_counter() - t0:.1f} s)")
    torch.cuda.empty_cache()

    # (b) the harness's own size: the card against the CPU, same parameters
    t0 = time.perf_counter()
    small, _ = common.get_dataset("kaggle")
    init = params_to_numpy(init_dlrm(small, torch.Generator().manual_seed(0),
                                     "cpu"))
    rows = {}
    for d in (dev, "cpu"):
        runs = {m: common.run_emulation(m, device=d, init_params=init)
                for m in fig7.MODES}
        rows[d] = [fig7.overhead_row("kaggle", m, r) for m, r in runs.items()]
        rows[d] += fig7.derived(rows[d])
        for row, r in zip(rows[d], runs.values()):
            row["logloss"] = round(r.logloss, 4)
    for a, b in zip(rows[dev], rows["cpu"]):
        same = all(a.get(k) == b.get(k) for k in FIG7_POLICY)
        mode = a["mode"]
        print(f"fig7 --fast ({small.name}) {mode}: card "
              f"{json.dumps({**a, 'device': label})} cpu "
              f"{json.dumps({**b, 'device': 'cpu'})} policy identical={same}")
        if not same:
            fail(f"fig7 {mode}: the card's policy differs from the CPU's")
        if mode in FIG7_HELD:
            gaps = (abs(a["auc"] - b["auc"]), abs(a["logloss"] - b["logloss"]))
            print(f"  auc gap {gaps[0]:.4f} (limit {FIG7_AUC_GAP}), eval "
                  f"logloss gap {gaps[1]:.4f} (limit {FIG7_LOGLOSS_GAP})")
            if gaps[0] > FIG7_AUC_GAP or gaps[1] > FIG7_LOGLOSS_GAP:
                fail(f"fig7 {mode}: the card's model differs from the CPU's")
    print(f"fig7 --fast card vs CPU: {time.perf_counter() - t0:.1f} s")

    # (c) table1 and fig14 at --fast size
    for name, mod in (("table1", table1), ("fig14", fig14)):
        t0 = time.perf_counter()
        before = dict(kernels.LAUNCHES)
        try:
            out = mod.run(device=dev, **harness.FAST_OVERRIDES.get(name, {}))
        except AssertionError as e:
            fail(f"{name}: an audit failed on the card: {e!r}")
        for row in out:
            print(f"{name} {json.dumps({**row, 'device': label})}")
        counts = launches_since(kernels, before)
        print(f"{name}: launches {json.dumps(counts)} "
              f"({time.perf_counter() - t0:.1f} s)")
        if name == "fig14" and (
                not all(r["matches_numpy_ref"] for r in out
                        if r["kind"] == "tracker_select")
                or counts["tracker_select"] == 0):
            fail("fig14: the card's segment-wise selection did not run "
                 "through tracker_select or disagrees with its plain version")

    # (d) the examples, each a process of its own on the card
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    for script, (mark, n_lines) in EXAMPLE_LINES.items():
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, str(root / "examples" / script)],
                           env=env, capture_output=True, text=True,
                           timeout=600)
        print(f"examples/{script} (exit {r.returncode}, "
              f"{time.perf_counter() - t0:.1f} s):")
        print("\n".join(f"  {line}" for line in r.stdout.splitlines()))
        if r.returncode:
            fail(f"examples/{script} failed: {r.stderr[-2000:]}")
        summary = [line for line in r.stdout.splitlines()
                   if re.match(mark, line)]
        if len(summary) != n_lines:
            fail(f"examples/{script} printed {len(summary)} summary lines, "
                 f"not {n_lines}")


def band_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps, queries right-aligned to the KV
    tail: the work a kernel that skips masked tiles must still do."""
    i = np.arange(Sq)[:, None] + (Skv - Sq)
    j = np.arange(Skv)[None, :]
    keep = np.ones((Sq, Skv), bool)
    if causal:
        keep &= j <= i
    if window:
        keep &= (i - j) < window
    return int(keep.sum())


def phase_lm_kernels(dev, ops, ref):
    """``flash_attention`` and ``rglru_scan`` against their plain versions
    at the serving path's shapes (phase 2b)."""
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(2)
    rows = {}
    for name, (B, Hq, Hkv, S, hd), dtype, window, cap, (rtol, atol) in \
            FLASH_CASES:
        q = torch.randn((B, S, Hq, hd), generator=gen, device=dev).to(dtype)
        k = torch.randn((B, S, Hkv, hd), generator=gen, device=dev).to(dtype)
        v = torch.randn((B, S, Hkv, hd), generator=gen, device=dev).to(dtype)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def kernel():
            return ops.flash_attention(q, k, v, causal=True, window=window,
                                       softcap=cap)

        def plain():
            return ref.flash_attention(qt, kt, vt, True, window, cap)

        want = plain().transpose(1, 2).float()

        def excess(got):
            """max |got - want| and its largest ratio to the limit."""
            diff = (got.float() - want).abs()
            return (diff.max().item(),
                    (diff / (rtol * want.abs() + atol)).max().item())

        err, ratio = excess(kernel())
        # what a kernel whose window edge sat one key tile off would read
        # (the plain version with the window one tile shorter): the limit
        # must reject it
        off = (excess(ref.flash_attention(qt, kt, vt, True, window - KEY_TILE,
                                          cap).transpose(1, 2))
               if window else None)
        pairs = B * Hq * band_pairs(S, S, True, window)
        rate = BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S
        t_b, by = bound((q.numel() * 2 + k.numel() * 2) * q.element_size(),
                        ops=4 * hd * pairs, ops_per_s=rate)
        library = None
        if not cap:         # one PyTorch call computes the same function
            i = torch.arange(S, device=dev)
            band = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :]
                                                 < (window or S + 1))
            library = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=band, enable_gqa=True))
        row = dict(max_abs_err=err, ms=time_ms(kernel), plain_ms=time_ms(plain),
                   bound_ms=t_b, bound_by=by, library_ms=library)
        ok = ratio <= 1.0
        print(f"flash_attention {name}: q {tuple(q.shape)} k {tuple(k.shape)} "
              f"{str(dtype)[6:]} window={window} softcap={cap} "
              f"pairs={pairs} max_abs_err={err:.3e} limit |err| <= "
              f"{rtol:g}*|plain| + {atol:g} (largest share of it "
              f"{ratio:.3f}) ok={ok} ms={row['ms']:.4f} "
              f"plain_ms={row['plain_ms']:.4f} bound_ms={t_b:.5f} ({by}) "
              f"library_ms={library}")
        if off is not None:
            print(f"  window one key tile ({KEY_TILE}) short would read: "
                  f"max_abs_err={off[0]:.3e}, {off[1]:.1f} times the limit")
            if off[1] <= 1.0:
                fail(f"the flash_attention {name} limit would not see a "
                     f"window one tile off")
        if not ok:
            fail(f"flash_attention {name} disagrees with its plain version")
        rows.setdefault("flash_attention", row)    # the serving path's case
        del q, k, v, qt, kt, vt, want

    for dtype in (torch.float32, torch.bfloat16):
        a = torch.sigmoid(torch.randn(SCAN_SHAPE, generator=gen,
                                      device=dev)).to(dtype)
        b = (torch.randn(SCAN_SHAPE, generator=gen, device=dev) * 0.1
             ).to(dtype)
        got, want = ops.rglru_scan(a, b), ref.rglru_scan(a, b)
        err = (got.float() - want.float()).abs().max().item()
        t_b, by = bound(3 * a.numel() * a.element_size(), ops=2 * a.numel())
        row = dict(max_abs_err=err,
                   ms=time_ms(lambda: ops.rglru_scan(a, b)),
                   plain_ms=time_ms(lambda: ref.rglru_scan(a, b)),
                   bound_ms=t_b, bound_by=by, library_ms=None)
        own, _ = device_ms(lambda: ops.rglru_scan(a, b), "rglru_scan_kernel")
        # a yardstick, not the same function: one elementwise pass that
        # moves the same bytes (reads a and b, writes one output)
        h = torch.empty_like(a)
        add_ms = time_ms(lambda: torch.add(a, b, out=h))
        print(f"rglru_scan {tuple(a.shape)} {str(dtype)[6:]}: "
              f"max_abs_err={err:.3e} (bit-exact expected) "
              f"differing={int((got != want).sum())} ms={row['ms']:.4f} "
              f"(CUDA events, one call) kernel device ms="
              f"{'not measured' if own is None else f'{own:.4f}'} "
              f"(profiler) plain_ms={row['plain_ms']:.4f} bound_ms="
              f"{t_b:.5f} ({by}) library_ms=None (no PyTorch call scans a "
              f"recurrence); yardstick torch.add(a, b) over the same "
              f"tensors ms={add_ms:.4f}")
        if not torch.equal(got, want):
            fail("rglru_scan disagrees with its plain version")
        rows.setdefault("rglru_scan", row)         # f32, as the path runs it
    torch.cuda.empty_cache()
    return rows


def phase_serving(dev, kernels, cfg):
    """The serving path at full width (phase 3b): one prefill ``forward``
    over ``PREFILL_SHAPE`` tokens, then ``serve()`` answers 8 requests;
    then the prefill's time over more forwards and a decode step's time at
    a context past the window (``profile_serve``'s workload)."""
    from repro_torch.launch import profile_serve as P
    from repro_torch.launch.serve import make_requests, serve
    from repro_torch.models import transformer as T
    arch = cfg.name
    t0 = time.perf_counter()
    params = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_params = T.param_count(params)
    print(f"{arch}: {n_params:,} parameters, f32 ({n_params * 4 / 1e9:.2f} "
          f"GB) on the card, {cfg.dtype} activations "
          f"({time.perf_counter() - t0:.1f} s to draw)")
    gen = torch.Generator(device=dev).manual_seed(1)
    kinds = cfg.layer_kinds
    want = {"flash_attention": sum(k != "rglru" for k in kinds),
            "rglru_scan": sum(k == "rglru" for k in kinds)}
    toks = torch.randint(0, cfg.vocab_size, P.PREFILL_SHAPE, generator=gen,
                         device=dev)
    T.forward(params, {"tokens": toks[:, :256]}, cfg)      # warm-up
    reqs = make_requests(8, 64, cfg.vocab_size, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def prefill():
        t0 = time.perf_counter()
        logits, _ = T.forward(params, {"tokens": toks}, cfg)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, logits

    kernels.reset_launches()
    prefill_s, logits = prefill()
    finite = bool(torch.isfinite(logits).all())
    shape = tuple(logits.shape)
    del logits
    done, stats = serve(cfg, reqs, batch=4, gen=32, params=params, device=dev)
    counts = dict(kernels.LAUNCHES)

    times = [prefill_s] + [prefill()[0] for _ in range(P.PREFILL_REPS - 1)]
    prefill_s = statistics.median(times)
    decode = P.decode_past_window(params, cfg, dev, gen)
    step_s = []
    for i in range(P.DECODE_WARMUP + P.DECODE_STEPS):
        t0 = time.perf_counter()
        decode(i)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    step_ms = statistics.median(step_s[P.DECODE_WARMUP:]) * 1e3

    n_tok = P.PREFILL_SHAPE[0] * P.PREFILL_SHAPE[1]
    print(f"prefill {arch} {P.PREFILL_SHAPE}: median of {P.PREFILL_REPS} "
          f"forwards {prefill_s * 1e3:.1f} ms (each: "
          f"{', '.join(f'{t * 1e3:.1f}' for t in times)}), "
          f"{n_tok / prefill_s:.0f} tokens/s, logits {shape} finite="
          f"{finite}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    print(f"serve {arch}: {len(done)} requests (prompts "
          f"{min(map(len, reqs))}..{max(map(len, reqs))} tokens, so a "
          f"cache of {max(map(len, reqs)) + 32} slots), batch 4, gen 32: "
          f"{stats['tokens']} tokens in "
          f"{stats['wall_s']:.2f} s -> {stats['tok_per_s']:.1f} tokens/s, "
          f"{stats['wall_s'] / stats['steps'] * 1e3:.2f} ms per decode step "
          f"({stats['steps']} steps, {stats['refills']} refills)")
    print(f"decode past the window {arch}: batch {P.DECODE_BATCH}, f32 "
          f"state with a full {cfg.sliding_window}-slot ring per local "
          f"layer, {cfg.dtype} activations: median {step_ms:.2f} ms per "
          f"step over {P.DECODE_STEPS} steps (each synchronized), "
          f"{P.DECODE_BATCH / step_ms * 1e3:.1f} tokens/s")
    print(f"launches (prefill + serve): {json.dumps(counts)}")
    if shape != (*P.PREFILL_SHAPE, cfg.vocab_size) or not finite:
        fail("prefill logits have the wrong shape or are not finite")
    if sorted(done) != list(range(8)) or any(
            len(c) != 32 or not all(0 <= t < cfg.vocab_size for t in c)
            for c in done.values()):
        fail("serve() did not answer every request with 32 tokens")
    for name, n in want.items():
        if counts[name] != n:
            fail(f"{name} launched {counts[name]} times in the serving path, "
                 f"not {n}")
    return params, counts


def phase_lm_agreement(dev, params, cfg, small):
    """Prefill against decode at full width in f32 over AGREE_SEQ tokens,
    then the ``small`` config on the card against the CPU (phase 4b)."""
    import dataclasses

    from repro_torch.launch.serve import make_requests, serve
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    arch = cfg.name
    cfg = dataclasses.replace(cfg, dtype="float32")
    S = AGREE_SEQ
    gen = torch.Generator(device=dev).manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (2, S), generator=gen, device=dev)
    t0 = time.perf_counter()
    full, _ = T.forward(params, {"tokens": toks}, cfg)
    state = T.init_decode_state(cfg, 2, S, torch.float32, dev)
    err = torch.zeros((), device=dev)
    W = cfg.sliding_window
    for i in range(S):
        if i == W:              # time the steps past the window
            torch.cuda.synchronize()
            t_past = time.perf_counter()
        logits, state = T.decode_step(params, state, toks[:, i], i, cfg)
        err = torch.maximum(err, (logits - full[:, i]).abs().max())
    torch.cuda.synchronize()
    past_ms = (time.perf_counter() - t_past) / (S - W) * 1e3
    scale = full.abs().max().item()
    err = err.item()
    # f32 throughout; the two paths sum in different orders (flash tiles
    # and the scan kernel against the ring cache and the one-step
    # recurrence), so they agree to f32 rounding, well inside 1e-4 of the
    # largest logit
    ok = err <= 1e-4 * scale
    print(f"prefill vs decode ({arch}, f32, (2, {S}) tokens): "
          f"max_abs_err={err:.3e} over every position, max |logit|="
          f"{scale:.4f}, tol=1e-4*max|logit| ok={ok} "
          f"({time.perf_counter() - t0:.1f} s); decode steps past the "
          f"window (positions {W}..{S - 1}, batch 2, f32 activations): "
          f"{past_ms:.2f} ms per step, not synchronized per step")
    if not ok:
        fail("prefill and decode disagree at full width")
    del full, state
    torch.cuda.empty_cache()

    cfg = small
    cpu = T.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    card = tree_map(lambda t: t.to(dev), cpu)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 128)))
    got, _ = T.forward(card, {"tokens": toks.to(dev)}, cfg)
    want, _ = T.forward(cpu, {"tokens": toks}, cfg)
    err = (got.cpu() - want).abs().max().item()
    reqs = make_requests(8, 24, cfg.vocab_size, seed=0)
    a, _ = serve(cfg, reqs, batch=4, gen=16, params=card, device=dev)
    b, _ = serve(cfg, reqs, batch=4, gen=16, params=cpu, device="cpu")
    # f32 sums in another order on the card (cuBLAS, the kernels)
    ok = err <= 1e-4 and a == b
    print(f"agreement ({cfg.name}, f32): card vs CPU forward "
          f"max_abs_err={err:.3e} tol=1e-4; serve() greedy completions of 8 "
          f"requests identical={a == b} ok={ok}")
    if not ok:
        fail("the reduced model on the card disagrees with the CPU path")


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on a GPU")
    t_start = time.perf_counter()
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import kernels, resolve_device
    from repro_torch.kernels import _build
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import row_hash as rh
    from repro_torch.kernels import ssu_dedupe as sd
    from repro_torch.kernels import tracker_select as ts

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    dev = resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")

    t0 = time.perf_counter()
    out_dir = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s into {out_dir}")
    for log in sorted(out_dir.glob("*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {log.stem}: {line.strip()}")
    lib = out_dir / "libflash_attention_bf16.so"
    sass = subprocess.run([str(Path(_build._nvcc()).parent / "cuobjdump"),
                           "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    n_hgmma = sum("HGMMA" in line for line in sass.splitlines())
    print(f"  {lib.name}: {n_hgmma} HGMMA (wgmma) instructions in its SASS")
    if not n_hgmma:
        fail("the bf16 flash_attention kernel has no tensor-core instructions")

    def phase_done(name):
        print(f"phase {name} done at {time.perf_counter() - t_start:.1f} s")

    rows = phase_kernels(dev, eb, ts, sd, ref)
    rows["row_hash"] = phase_row_hash(dev, rh, ref)
    phase_done("2")
    from repro_torch.configs.dlrm import DLRM_KAGGLE
    launches = phase_main_path(dev, kernels, DLRM_KAGGLE)
    phase_done("3")
    phase_agreement(dev)
    torch.cuda.empty_cache()
    phase_done("4")
    phase_harness(dev, kernels, DLRM_KAGGLE)
    torch.cuda.empty_cache()
    phase_done("5")
    harness_hashes = phase_fleet_figures(dev, kernels, DLRM_KAGGLE)
    torch.cuda.empty_cache()
    phase_done("6")

    from repro_torch.configs import get_config
    rows.update(phase_lm_kernels(dev, ops, ref))
    from repro_torch.launch.profile_serve import ARCH
    lm = get_config(ARCH)
    params, lm_launches = phase_serving(dev, kernels, lm)
    for name in ("flash_attention", "rglru_scan"):
        launches[name] = lm_launches[name]
    phase_lm_agreement(dev, params, lm, lm.reduced())
    del params
    torch.cuda.empty_cache()
    phase_done("4b")

    sources = {"embedding_bag": "embedding_bag.cu",
               "embedding_bag_backward": "embedding_bag.cu",
               "tracker_select": "tracker_select.cu",
               "ssu_dedupe_evict": "ssu_dedupe.cu",
               "row_hash": "row_hash.cu",
               "flash_attention": "flash_attention_bf16.cu",
               "rglru_scan": "rglru_scan.cu"}
    replaces = {"embedding_bag": "src/repro/kernels/embedding_bag.py:44",
                "embedding_bag_backward": "src/repro/models/dlrm.py:82",
                "tracker_select": "src/repro/kernels/tracker_select.py:112",
                "ssu_dedupe_evict": "src/repro/kernels/ssu_dedupe.py:59",
                "row_hash": "src/repro/kernels/row_hash.py:71",
                "flash_attention": "src/repro/kernels/flash_attention.py:90",
                "rglru_scan": "src/repro/kernels/rglru_scan.py:53"}
    rows["row_hash"]["harness_launches"] = harness_hashes
    line = [{"name": name, "route": "cuda",
             "source": f"src/repro_torch/csrc/{sources[name]}",
             "replaces": replaces[name], "launches": launches[name],
             **rows[name]} for name in sources]
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
