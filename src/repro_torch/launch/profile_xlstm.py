"""Where xLSTM-1.3B's time goes, block by block, at full width.

    PYTHONPATH=src python -m repro_torch.launch.profile_xlstm [--reps 3]

Draws one mLSTM and one sLSTM layer of ``xlstm-1.3b`` (d 2,048, 4 heads
of 512; f32 parameters from a seeded generator, bf16 activations, the
config's dtype) and runs each block alone on the work of ``chip_smoke.py``
phases 3x and 7x: the prefill's (2, 4096) forward, a training step's
(8, 512) forward and backward, and one decode step at batch 4.  For each
it prints the host ms a call (the median of ``--reps``, each ending in a
synchronize) and, from one call under ``torch.profiler``, the device busy
ms and the number of device operations.  Then the model's share of each:
42 mLSTM and 6 sLSTM layers, the sLSTM's loop over time against the rest.
Needs a GPU.
"""
from __future__ import annotations

import argparse
import statistics
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import xlstm as X

ARCH = "xlstm-1.3b"
PREFILL = (2, 4096)
TRAIN = (8, 512)
DECODE_BATCH = 4


def _measure(fn, reps, dev):
    """(median host ms of ``reps`` synchronized calls, device busy ms and
    device operations of one profiled call)."""
    fn()                                                   # warm-up
    times = []
    for _ in range(reps):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(dev)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    return statistics.median(times), busy, sum(e.count for e in events)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    cfg = get_config(ARCH)
    d, H, dt = cfg.d_model, cfg.num_heads, getattr(torch, cfg.dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    blocks = {"mlstm": (X.init_mlstm(gen, d, H, dev), X.mlstm_forward,
                        X.init_mlstm_state, X.mlstm_decode),
              "slstm": (X.init_slstm(gen, d, H, dev), X.slstm_forward,
                        X.init_slstm_state, X.slstm_decode)}
    layers = {k: cfg.layer_kinds.count(k) for k in blocks}
    print(f"{torch.cuda.get_device_name(0)}; {ARCH} blocks at full width "
          f"(d {d}, {H} heads), f32 parameters, {cfg.dtype} activations; "
          f"layers {layers}; host ms median of {args.reps}, device from "
          f"one profiled call")

    def rand(shape):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    work = {}
    for kind, (p, forward, init_state, decode) in blocks.items():
        x_pre, x_train, x_dec = rand(PREFILL + (d,)), rand(TRAIN + (d,)), \
            rand((DECODE_BATCH, 1, d))
        for t in p.values():
            t.requires_grad_(True)

        def prefill():
            with torch.no_grad():
                forward(p, x_pre, H)

        def train_step():
            forward(p, x_train, H).float().sum().backward()

        def decode_step():
            with torch.no_grad():
                decode(p, x_dec, init_state(d, H, DECODE_BATCH, dev), H)

        for name, fn in (("prefill", prefill), ("train", train_step),
                         ("decode", decode_step)):
            work[(kind, name)] = _measure(fn, args.reps, dev)
            host, busy, ops = work[(kind, name)]
            print(f"  {kind} {name}: host {host:.3f} ms, device busy "
                  f"{busy:.3f} ms ({100 * busy / host:.1f} %), {ops} device "
                  f"operations")
    for name, shape in (("prefill", PREFILL), ("train", TRAIN),
                        ("decode", (DECODE_BATCH, 1))):
        total = {k: layers[k] * work[(k, name)][0] for k in blocks}
        ops = {k: layers[k] * work[(k, name)][2] for k in blocks}
        whole = sum(total.values())
        print(f"{name} {shape}, the 48 blocks: host {whole:.1f} ms, of it "
              f"the 6 sLSTM layers {total['slstm']:.1f} ms "
              f"({100 * total['slstm'] / whole:.1f} %) and the 42 mLSTM "
              f"{total['mlstm']:.1f} ms; device operations sLSTM "
              f"{ops['slstm']}, mLSTM {ops['mlstm']}")


if __name__ == "__main__":
    main()
