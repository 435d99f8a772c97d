"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, drive, time.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase catches its own failure):

1. The card (``nvidia-smi`` name and power limit) and the kernel build:
   every ``src/repro_torch/csrc/*.cu`` compiled by ``nvcc`` for sm_90a.
2. Each kernel against its plain PyTorch version at the shapes of the
   DLRM main path (largest Criteo-Kaggle table: N = 10,131,227, d = 16,
   B = 512), with its time (CUDA events, median of 25 after warm-up), the
   plain version's time, its bound (the bytes this run's inputs need over
   3.35 TB/s, or operations over the f32 peak, whichever is larger) and,
   where one PyTorch call computes the same function, that call's time.
   ``ssu_dedupe_evict`` is timed without overflow (the path's steady
   state, the one in the kernels line) and with it.
3. The main path: the port's ``Emulator`` trains the unscaled Criteo-Kaggle
   DLRM (26 tables, 33,762,577 rows, d = 16) under 2 injected failures in
   modes ``full``, ``cpr-mfu`` and ``cpr-ssu`` (kernel tracker backend),
   35 steps each at batch 512, then evaluates.  Launch counts are reset
   just before each mode and read just after.
4. The output checked against a reference on a small input: the scaled
   config trained on the card and on the CPU (the CPU path is held against
   the JAX reference by the tests) from the same parameters gives the same
   PLS, overhead charges and bytes written, and an AUC within 5e-3.
   Phase 2 checks the kernels alone; this checks what the whole path on
   the card (trackers, saves, restores, evaluation) hands back.

The last two lines are ``{"kernels": [...]}`` and ``{"ok": true, ...}``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
N_BIG, D, B = 10_131_227, 16, 512
STEPS = 35


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


def bound(nbytes: float, ops: float = 0.0):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def zipf_ids(rng, n_rows, shape):
    perm = rng.permutation(n_rows)
    ranks = np.minimum(rng.zipf(1.2, size=shape) - 1, n_rows - 1)
    return perm[ranks].astype(np.int32)


def phase_kernels(dev, eb, ts, sd, ref):
    """Each kernel vs its plain version at the path's shapes."""
    import torch.nn.functional as F
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    # ---- embedding_bag forward (f32, bf16; hot 1 and 3) and backward ----
    table = torch.rand((N_BIG, D), generator=gen, device=dev) - 0.5
    for hot in (1, 3):
        idx = torch.from_numpy(zipf_ids(rng, N_BIG, (B, hot))).to(dev)
        for dtype, tol in ((torch.float32, 1e-6), (torch.bfloat16, 2e-2)):
            tab = table.to(dtype)
            got = eb.forward(tab, idx).float()
            want = ref.embedding_bag(tab, idx).float()
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            ok = err <= tol * max(scale, 1.0)
            print(f"embedding_bag hot={hot} {str(dtype)[6:]}: "
                  f"max_abs_err={err:.3e} tol={tol:g} ok={ok}")
            if not ok:
                fail("embedding_bag disagrees with its plain version")
            if hot == 1 and dtype == torch.float32:
                itemsize = tab.element_size()
                t_b, by = bound(B * hot * D * itemsize + B * hot * 4 +
                                B * D * itemsize, ops=B * hot * D)
                flat = idx.reshape(-1).long()
                offsets = torch.arange(0, B * hot, hot, device=dev)
                rows["embedding_bag"] = dict(
                    max_abs_err=err,
                    ms=time_ms(lambda: eb.forward(tab, idx)),
                    plain_ms=time_ms(lambda: ref.embedding_bag(tab, idx)),
                    bound_ms=t_b, bound_by=by,
                    library_ms=time_ms(lambda: F.embedding_bag(
                        flat, tab, offsets, mode="sum")))
        grad_out = (torch.randn((B, D), generator=gen, device=dev) * 1e-2)
        got = eb.backward(grad_out, idx, N_BIG)
        want = ref.embedding_bag_backward(grad_out, idx, N_BIG)
        err = (got - want).abs().max().item()
        # atomic adds land in run-dependent order on repeated (Zipf) ids:
        # f32 rounding of sums of up to B*hot terms
        ok = err <= 1e-5 * max(want.abs().max().item(), 1.0)
        print(f"embedding_bag_backward hot={hot}: max_abs_err={err:.3e} "
              f"tol=1e-5 (relative to the largest gradient) ok={ok}")
        if not ok:
            fail("embedding_bag backward disagrees with its plain version")
        if hot == 1:
            t_b, by = bound(B * D * 4 + B * hot * 4 + N_BIG * D * 4,
                            ops=B * hot * D)
            flat = idx.reshape(-1).long()
            rows["embedding_bag_backward"] = dict(
                max_abs_err=err,
                ms=time_ms(lambda: eb.backward(grad_out, idx, N_BIG)),
                plain_ms=time_ms(lambda: ref.embedding_bag_backward(
                    grad_out, idx, N_BIG)),
                bound_ms=t_b, bound_by=by,
                library_ms=time_ms(lambda: torch.ops.aten.embedding_dense_backward(
                    grad_out, flat, N_BIG, -1, False)))
    del table

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
    del counts

    # ---- ssu_dedupe_evict: rn = 0.125 * N, nc = 256 ----
    rn, nc = int(0.125 * N_BIG), 256
    EMPTY = ref.EMPTY

    def reservoir(live):
        buf = np.full(rn, EMPTY, np.int32)
        buf[:live] = np.sort(rng.choice(N_BIG, size=live, replace=False))
        return buf

    def candidates(buf, live):
        c = zipf_ids(rng, N_BIG, (nc,))
        c[: nc // 4] = rng.choice(buf[:live], size=nc // 4)  # already present
        u = np.unique(c)
        out = np.full(nc, EMPTY, np.int32)
        out[:u.size] = u
        return out

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
        lc = np.setdiff1d(cand_np[cand_np != EMPTY], buf_np).size
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
        print(f"ssu_dedupe_evict timed, overflow={overflow}: {nbytes} bytes "
              f"needed; ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
              f"bound_ms={t_b:.5f}")
        if not overflow:                    # the path's steady state
            rows["ssu_dedupe_evict"] = row
    for name, r in rows.items():
        print(f"{name}: ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']}) "
              f"library_ms={r['library_ms']}")
    return rows


def phase_main_path(dev, kernels, cfg, num_samples=40_000):
    """Full-width Criteo-Kaggle emulation in three modes."""
    from repro_torch.core import (CPRManager, Emulator, FailureInjector,
                                  SystemParams)
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
    totals = {name: 0 for name in kernels.LAUNCHES}
    for mode, must in drives.items():
        p = SystemParams()
        mgr = CPRManager(mode, p, cfg.table_sizes, target_pls=0.1,
                         tracker_backend="kernel", device=dev)
        inj = FailureInjector(2, 0.25, p.N_emb, p.T_total, seed=11)
        emu = Emulator(cfg, ds, mgr, inj, batch_size=B, device=dev)
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = emu.run(max_steps=STEPS)
        wall = time.perf_counter() - t0
        counts = dict(kernels.LAUNCHES)
        for name, n in counts.items():
            totals[name] += n
        steady = statistics.median(emu.step_seconds[5:]) * 1e3
        print(res.summary())
        print(f"  {mode}: steps={res.n_steps} steady_ms_per_step={steady:.3f} "
              f"wall_s={wall:.1f} final_loss={res.final_loss:.5f} "
              f"bytes_written={res.report['bytes_written']} "
              f"save_blocked_s={res.report['overheads']['save_blocked_s']:.2f}"
              f" launches={json.dumps(counts)}")
        missing = [n for n in must if counts[n] == 0]
        if missing:
            fail(f"{mode}: kernels {missing} were never launched")
        if not math.isfinite(res.final_loss) or not math.isfinite(res.auc):
            fail(f"{mode}: loss or AUC is not finite")
        if mode != "full":
            restores = [h for h in mgr.history if h["event"] == "failure"]
            if mgr.effective_mode != mode or not restores:
                fail(f"{mode}: no partial-recovery restore happened")
        del emu, mgr
        torch.cuda.empty_cache()
    return totals


def phase_agreement(dev):
    """The scaled config on the card vs on the CPU, same parameters."""
    from repro_torch.configs.dlrm import DLRM_KAGGLE, scaled
    from repro_torch.core import (CPRManager, Emulator, FailureInjector,
                                  SystemParams)
    from repro_torch.data.synthetic import ClickLogDataset
    from repro_torch.models.dlrm import init_dlrm, params_to_numpy
    cfg = scaled(DLRM_KAGGLE, 2000)
    ds = ClickLogDataset(cfg.table_sizes, num_samples=8000, seed=3)
    init = params_to_numpy(init_dlrm(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    out = {}
    for device in (dev, "cpu"):
        p = SystemParams()
        mgr = CPRManager("cpr-mfu", p, cfg.table_sizes, target_pls=0.1,
                         tracker_backend="kernel", device=device)
        inj = FailureInjector(2, 0.25, p.N_emb, p.T_total, seed=11)
        out[str(device)] = Emulator(cfg, ds, mgr, inj, batch_size=256,
                                    device=device, init_params=init).run()
    card, cpu = out[str(dev)], out["cpu"]
    same = all(card.report["overheads"][k] == cpu.report["overheads"][k]
               for k in ("save", "load", "lost", "resched"))
    same &= card.report["measured_pls"] == cpu.report["measured_pls"]
    same &= card.report["bytes_written"] == cpu.report["bytes_written"]
    gap = abs(card.auc - cpu.auc)
    print(f"agreement (scaled, cpr-mfu): card auc={card.auc:.6f} "
          f"cpu auc={cpu.auc:.6f} gap={gap:.2e} charges/pls/bytes "
          f"identical={same}")
    if not same or gap > 5e-3:
        fail("the card's run disagrees with the CPU path")


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on a GPU")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import kernels, resolve_device
    from repro_torch.kernels import _build
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import ref
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

    rows = phase_kernels(dev, eb, ts, sd, ref)
    from repro_torch.configs.dlrm import DLRM_KAGGLE
    launches = phase_main_path(dev, kernels, DLRM_KAGGLE)
    phase_agreement(dev)

    sources = {"embedding_bag": "embedding_bag.cu",
               "embedding_bag_backward": "embedding_bag.cu",
               "tracker_select": "tracker_select.cu",
               "ssu_dedupe_evict": "ssu_dedupe.cu"}
    replaces = {"embedding_bag": "src/repro/kernels/embedding_bag.py:44",
                "embedding_bag_backward": "src/repro/models/dlrm.py:82",
                "tracker_select": "src/repro/kernels/tracker_select.py:112",
                "ssu_dedupe_evict": "src/repro/kernels/ssu_dedupe.py:59"}
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
