"""Where a full-width emulator step spends its device time.

    PYTHONPATH=src python -m repro_torch.launch.profile_emulator \\
        [--mode cpr-ssu] [--warmup 5] [--steps 10] [--top 15]

Runs the emulator as ``chip_smoke.py`` runs it (unscaled Criteo-Kaggle
DLRM, batch 512, 2 failures, kernel tracker backend, 35 steps) and wraps
steps ``warmup .. warmup+steps-1`` of ``Emulator.run``, with the saves and
failures between them, in ``torch.profiler`` (CPU and CUDA activities).
Prints the device time per step by kernel name, the window's device-busy
share, and the host ms per profiled step.  Needs a GPU.
"""
from __future__ import annotations

import argparse
import statistics
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import resolve_device
from repro_torch.configs.dlrm import DLRM_KAGGLE
from repro_torch.core import (CPRManager, Emulator, FailureInjector,
                              SystemParams)
from repro_torch.data.synthetic import ClickLogDataset

STEPS = 35


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="full")
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    if args.warmup < 1 or args.warmup + args.steps > STEPS:
        ap.error(f"need 1 <= warmup and warmup + steps <= {STEPS}")
    dev = resolve_device("cuda")
    cfg = DLRM_KAGGLE
    ds = ClickLogDataset(cfg.table_sizes, num_samples=40_000, seed=3)
    p = SystemParams()
    mgr = CPRManager(args.mode, p, cfg.table_sizes, target_pls=0.1,
                     tracker_backend="kernel", device=dev)
    emu = Emulator(cfg, ds, mgr,
                   FailureInjector(2, 0.25, p.N_emb, p.T_total, seed=11),
                   batch_size=512, device=dev)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = {}

    def on_step(i):
        if i == args.warmup - 1:
            prof.start()
            window["t0"] = time.perf_counter()
        elif i == args.warmup + args.steps - 1:
            torch.cuda.synchronize(dev)
            window["s"] = time.perf_counter() - window["t0"]
            prof.stop()

    emu.run(max_steps=STEPS, on_step=on_step)
    rows = sorted(((e.key, e.self_device_time_total, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows) / 1e3
    wall_ms = window["s"] * 1e3
    host = emu.step_seconds[args.warmup:args.warmup + args.steps]
    print(f"{torch.cuda.get_device_name(0)}; mode={args.mode}; steps "
          f"{args.warmup}..{args.warmup + args.steps - 1} of {STEPS} "
          f"profiled, with their saves and failures")
    print(f"host ms per train step (median): "
          f"{statistics.median(host) * 1e3:.3f}; window "
          f"{wall_ms / args.steps:.3f} ms per step; device busy "
          f"{busy_ms / args.steps:.3f} ms per step "
          f"({100 * busy_ms / wall_ms:.1f}%)")
    for key, us, n in rows[:args.top]:
        print(f"  {us / 1e3 / args.steps:9.4f} ms/step  "
              f"{100 * us / 1e3 / busy_ms:5.1f}%  x{n / args.steps:<5.1f} "
              f"{key[:90]}")


if __name__ == "__main__":
    main()
