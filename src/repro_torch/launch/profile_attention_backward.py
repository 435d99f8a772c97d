"""Where the attention kernels spend their time on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_attention_backward \\
        [--dtype bf16,f32] [--forward]

At the backward shapes of ``chip_smoke.py`` phase 2c (bf16: the training
path's, the window case's, gemma2's with softcap; f32: the LM example's
and the training check 7 (b)'s at full width), with the forward's
log-sum-exp handed over as ``ops`` hands it, prints for each: the device
time per call by kernel (``torch.profiler``, 10 calls), the CUDA-event
time per call over 50 calls back to back and of one call alone (median of
25), and the host time to enqueue a call.  ``--forward`` adds the f32
forward at phase 4b's prefill shape, timed the same way.  First the
card's name and power limit and the attention libraries' registers and
spills (``ptxas -v``, from the build's log).  Needs a GPU.

Run by path against another tree's package (``PYTHONPATH=<tree>/src
python src/repro_torch/launch/profile_attention_backward.py``), it times
that tree's kernels: the same-call A/B of a change.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa

# by dtype, name: (B, Hq, Hkv, S, hd), window, softcap; causal, queries
# over all keys
CASES = {
    "bf16": {
        "training (8, 10, 512, 256)": ((8, 10, 1, 512, 256), 2048, 0.0),
        "window bites (2, 10, 4096, 256)": ((2, 10, 1, 4096, 256), 2048,
                                            0.0),
        "gemma2 global softcap (1, 8, 4096, 256)": ((1, 8, 4, 4096, 256), 0,
                                                    50.0)},
    "f32": {
        "lm-100m example (4, 8, 4, 128, 64)": ((4, 8, 4, 128, 64), 256, 0.0),
        "training check 7 (b) (1, 10, 1, 2176, 256)": ((1, 10, 1, 2176, 256),
                                                       2048, 0.0)}}
FORWARD_CASES = {
    "f32 prefill phase 4b (2, 10, 1, 2176, 256)": ((2, 10, 1, 2176, 256),
                                                   2048, 0.0)}
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
LIBS = ("flash_attention", "flash_attention_backward",
        "flash_attention_backward_bf16")


def _kernel_name(key: str) -> str:
    """``flash_bwd_dq<256>`` from the profiler's demangled signature or
    ptxas's mangled name; other keys as they are."""
    m = (re.search(r"::(\w+<\d+>)\(", key)
         or re.search(r"\d+(flash_\w+?)ILi(\d+)E", key))
    if m is None:
        return key
    return m.group(1) if m.lastindex == 1 else f"{m.group(1)}<{m.group(2)}>"


def _events_ms(fn, calls: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def time_call(dev, call, reps: int = 10) -> dict:
    """Device ms by kernel (profiler), CUDA-event ms back to back and of
    one call alone, host enqueue ms of ``call``."""
    for _ in range(3):
        call()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize(dev)
    by_kernel = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            name = _kernel_name(e.key)
            by_kernel[name] = round(by_kernel.get(name, 0.0)
                                    + e.device_time_total / reps / 1e3, 4)
    t0 = time.perf_counter()
    for _ in range(50):
        call()
    host_ms = (time.perf_counter() - t0) / 50 * 1e3
    torch.cuda.synchronize(dev)
    back_to_back = _events_ms(call, 50)
    alone = statistics.median(_events_ms(call, 1) for _ in range(25))
    return {"device_ms_by_kernel": by_kernel,
            "device_ms": round(sum(by_kernel.values()), 4),
            "back_to_back_ms": round(back_to_back, 4),
            "one_call_ms": round(alone, 4),
            "host_enqueue_ms": round(host_ms, 4)}


def _inputs(dev, shape, dtype):
    B, Hq, Hkv, S, hd = shape
    gen = torch.Generator(device=dev).manual_seed(4)
    return [torch.randn((B, h, S, hd), generator=gen, device=dev).to(dtype)
            for h in (Hq, Hkv, Hkv, Hq)]


def profile_case(dev, shape, window, softcap, dtype=torch.bfloat16) -> dict:
    q, k, v, do = _inputs(dev, shape, dtype)
    out, lse = fa.flash_attention(q, k, v, True, window, softcap,
                                  return_lse=True)
    return time_call(dev, lambda: fa.flash_attention_backward(
        q, k, v, out, do, True, window, softcap, lse=lse))


def profile_forward(dev, shape, window, softcap,
                    dtype=torch.float32) -> dict:
    q, k, v, _ = _inputs(dev, shape, dtype)
    return time_call(dev, lambda: fa.flash_attention(q, k, v, True, window,
                                                     softcap))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", default="bf16,f32",
                    help="comma-separated: bf16, f32")
    ap.add_argument("--forward", action="store_true",
                    help="also the f32 forward at phase 4b's shape")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    out_dir = _build.build_all()
    for lib in LIBS:
        log = out_dir / f"lib{lib}.log"
        if not log.exists():
            continue
        name = ""
        for line in log.read_text().splitlines():
            if "Compiling entry function" in line:
                name = _kernel_name(line.split("'")[1])
            elif "registers" in line or "spill" in line:
                print(f"{lib}: {name}: {line.strip()}")
    for key in args.dtype.split(","):
        for case, (shape, window, softcap) in CASES[key].items():
            print(f"backward {key} {case}", json.dumps(profile_case(
                dev, shape, window, softcap, DTYPES[key])), flush=True)
    if args.forward:
        for case, (shape, window, softcap) in FORWARD_CASES.items():
            print(f"forward {case}", json.dumps(profile_forward(
                dev, shape, window, softcap)), flush=True)


if __name__ == "__main__":
    main()
