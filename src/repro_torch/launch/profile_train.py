"""Where a full-width LM training step spends its device time.

    PYTHONPATH=src python -m repro_torch.launch.profile_train \\
        [--arch xlstm-1.3b] [--mode cpr-mfu] [--warmup 2] [--steps 4] \\
        [--top 15]

Trains a model at full width (``ARCH`` unless ``--arch``) as
``chip_smoke.py`` phases 7 (a) and 7x do (batch 8 x 512, 2 failures,
kernel tracker backend, the flat store)
and wraps ``--steps`` steps after ``--warmup`` in ``torch.profiler`` (CPU
and CUDA activities), with the saves and failures between them.  The
window runs from one step's gradient (``train``'s ``on_step``) to a later
step's, so it holds whole steps.  Prints the device time per step by
kernel name, the window's device-busy share, and the host ms per
profiled step.  Needs a GPU.
"""
from __future__ import annotations

import argparse
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import resolve_device
from repro_torch.configs import get_config, list_archs
from repro_torch.launch.train import train

ARCH = "recurrentgemma-2b"
BATCH, SEQ = 8, 512


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=ARCH, choices=list_archs())
    ap.add_argument("--mode", default="cpr-mfu")
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    if args.warmup < 1 or args.steps < 1:
        ap.error("need warmup >= 1 and steps >= 1")
    dev = resolve_device("cuda")
    cfg = get_config(args.arch)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = {}

    def on_step(i, grads):
        if i == args.warmup:
            prof.start()
            window["t0"] = time.perf_counter()
        elif i == args.warmup + args.steps:
            torch.cuda.synchronize(dev)
            window["s"] = time.perf_counter() - window["t0"]
            prof.stop()

    _, hist = train(cfg, steps=args.warmup + args.steps + 1, batch=BATCH,
                    seq=SEQ, mode=args.mode, tracker_backend="kernel",
                    device=dev, log_every=10 ** 9, on_step=on_step)
    rows = sorted(((e.key, e.self_device_time_total, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows) / 1e3
    wall_ms = window["s"] * 1e3
    n = args.steps
    print(f"{torch.cuda.get_device_name(0)}; {cfg.name} at full width, batch "
          f"{BATCH} x {SEQ}, mode={args.mode}; {n} steps after step "
          f"{args.warmup} profiled, with their saves and failures")
    print(f"window {wall_ms / n:.3f} ms per step (host clock, profiled), "
          f"device busy {busy_ms / n:.3f} ms per step "
          f"({100 * busy_ms / wall_ms:.1f} %), "
          f"{sum(r[2] for r in rows) / n:.0f} device operations per step")
    print(f"step ms, each synchronized (the profiled ones included): "
          f"{', '.join(f'{t * 1e3:.1f}' for t in hist['step_s'])}")
    print(f"{'device ms/step':>14} {'calls/step':>10}  kernel")
    for key, us, count in rows[:args.top]:
        print(f"{us / 1e3 / n:14.3f} {count / n:10.1f}  {key[:110]}")


if __name__ == "__main__":
    main()
