"""Where the full-width serving path spends its device time.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        [--arch qwen2-moe-a2.7b]

Draws the full-width model (``ARCH`` unless ``--arch``) as
``chip_smoke.py`` phases 3b and 3m do (f32
parameters from a seeded generator, ``cfg.dtype`` activations), warms up,
then profiles with ``torch.profiler`` (CPU and CUDA activities): one
prefill ``forward`` over ``PREFILL_SHAPE`` tokens, and ``DECODE_STEPS``
decode steps at ``DECODE_BATCH`` on an f32 decode state (as ``serve``
holds it) sized for ``PREFILL_SHAPE[1]`` tokens, so each local layer's
ring holds the full window and every step attends all of it: the work of
a step at any context past the window (a global layer's cache, as an MoE
layer's, holds all 4,096 slots).  Prints for each the host ms, the
device busy ms and share, and the device time by kernel name (the top
15, and the port's own kernels wherever they rank).  Then it times
``PREFILL_REPS`` unprofiled prefills (host clock around each, ending in a
synchronize) and prints their median.  Needs a GPU.  Nothing is recorded
for autograd.

The constants below are the workload of ``chip_smoke.py`` phase 3b,
which imports them.
"""
from __future__ import annotations

import argparse
import statistics
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import resolve_device
from repro_torch.configs import get_config, list_archs
from repro_torch.models import transformer as T

ARCH = "recurrentgemma-2b"
PREFILL_SHAPE = (2, 4096)      # (batch, tokens): both pass the 2048 window
PREFILL_REPS = 5               # prefill time: the median of this many
DECODE_BATCH = 4
DECODE_STEPS = 16
DECODE_WARMUP = 4
TOP = 15
PORT_KERNELS = ("rglru_scan", "flash_fwd")   # listed wherever they rank


def decode_past_window(params, cfg, dev, gen):
    """``fn(i)`` runs decode step ``i`` of a batch-``DECODE_BATCH`` f32
    decode state sized for ``PREFILL_SHAPE[1]`` tokens, at a position past
    the window (the state's ring is full width; steps attend every slot)."""
    state = T.init_decode_state(cfg, DECODE_BATCH, PREFILL_SHAPE[1],
                                torch.float32, dev)
    cur = torch.randint(0, cfg.vocab_size, (DECODE_BATCH,), generator=gen,
                        device=dev)
    start = PREFILL_SHAPE[1] - DECODE_WARMUP - DECODE_STEPS

    def step(i):
        T.decode_step(params, state, cur, start + i, cfg)

    return step


def _report(name, prof, wall_s, n):
    rows = sorted(((e.key, e.self_device_time_total, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows) / 1e3
    wall_ms = wall_s * 1e3
    print(f"{name}: host {wall_ms / n:.3f} ms per call; device busy "
          f"{busy_ms / n:.3f} ms per call ({100 * busy_ms / wall_ms:.1f}% of "
          f"the window), {sum(r[2] for r in rows) / n:.0f} kernels per call")
    for i, (key, us, count) in enumerate(rows):
        if i < TOP or any(k in key for k in PORT_KERNELS):
            print(f"  {us / 1e3 / n:9.4f} ms  {100 * us / 1e3 / busy_ms:5.1f}%"
                  f"  x{count / n:<6.1f} {key[:90]}")


def _profiled(fn, n, dev):
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    torch.cuda.synchronize(dev)
    with prof:
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    return prof, wall


@torch.no_grad()
def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=ARCH, choices=list_archs())
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    cfg = get_config(args.arch)
    params = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, PREFILL_SHAPE, generator=gen,
                         device=dev)
    print(f"{torch.cuda.get_device_name(0)}; {cfg.name}, "
          f"{T.param_count(params):,} f32 parameters, {cfg.dtype} "
          f"activations")

    def prefill(_):
        T.forward(params, {"tokens": toks}, cfg)

    prefill(0)                                           # warm-up
    prof, wall = _profiled(prefill, 1, dev)
    _report(f"prefill {PREFILL_SHAPE}", prof, wall, 1)

    decode = decode_past_window(params, cfg, dev, gen)
    for i in range(DECODE_WARMUP):
        decode(i)
    prof, wall = _profiled(lambda i: decode(DECODE_WARMUP + i), DECODE_STEPS,
                           dev)
    _report(f"decode step (batch {DECODE_BATCH}, f32 state, past the "
            f"window)", prof, wall, DECODE_STEPS)

    times = []
    for _ in range(PREFILL_REPS):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        prefill(0)
        torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"prefill {PREFILL_SHAPE} unprofiled: median of {PREFILL_REPS} "
          f"{statistics.median(times):.3f} ms (each: "
          f"{', '.join(f'{t:.3f}' for t in times)})")


if __name__ == "__main__":
    main()
