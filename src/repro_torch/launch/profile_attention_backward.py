"""Where the attention kernels spend their time on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_attention_backward \\
        [--dtype bf16,f32] [--forward] [--only SUBSTRING]

At the backward shapes of ``chip_smoke.py`` phase 2c (bf16: the training
path's, the window case's, gemma2's with softcap, HuBERT X-Large's
bidirectional head dim 80; f32: the LM example's and the training check
7 (b)'s at full width), with the forward's log-sum-exp handed over as
``ops`` hands it, prints for each: the device time per call by kernel
(``torch.profiler``, 10 calls), the CUDA-event time per call over 50
calls back to back and of one call alone (median of 25), the host time
to enqueue a call, their difference ``host_path_ms`` (one call's ms minus
its device ms) and, without a softcap, the one-call ms of
``F.scaled_dot_product_attention``'s backward on the same inputs (the
yardstick, never the port's path).  ``--forward`` adds the forwards (f32
at phase 4b's prefill shape, bf16 at HuBERT's), timed the same way beside
SDPA's forward.  ``--only`` keeps the cases whose name holds the
substring.  First the card's name and power limit and the attention
libraries' registers and spills (``ptxas -v``, from the build's log).
Needs a GPU.

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
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

# by dtype, name: (B, Hq, Hkv, S, hd), causal, window, softcap; queries
# over all keys
HUBERT = "hubert-xlarge hd 80 (8, 16, 1000, 80)"
CASES = {
    "bf16": {
        "training (8, 10, 512, 256)": ((8, 10, 1, 512, 256), True, 2048, 0.0),
        "window bites (2, 10, 4096, 256)": ((2, 10, 1, 4096, 256), True, 2048,
                                            0.0),
        "gemma2 global softcap (1, 8, 4096, 256)": ((1, 8, 4, 4096, 256),
                                                    True, 0, 50.0),
        HUBERT: ((8, 16, 16, 1000, 80), False, 0, 0.0)},
    "f32": {
        "lm-100m example (4, 8, 4, 128, 64)": ((4, 8, 4, 128, 64), True, 256,
                                               0.0),
        "training check 7 (b) (1, 10, 1, 2176, 256)": ((1, 10, 1, 2176, 256),
                                                       True, 2048, 0.0)}}
FORWARD_CASES = {
    "f32 prefill phase 4b (2, 10, 1, 2176, 256)": (
        (2, 10, 1, 2176, 256), True, 2048, 0.0, torch.float32),
    HUBERT: ((8, 16, 16, 1000, 80), False, 0, 0.0, torch.bfloat16)}
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
LIBS = ("flash_attention", "flash_attention_backward",
        "flash_attention_backward_bf16")


def _kernel_name(key: str) -> str:
    """``flash_bwd_dq<256>`` from the profiler's demangled signature or
    ptxas's mangled name; other keys as they are."""
    m = (re.search(r"::(\w+<[\w, ]+>)\(", key)
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


def time_call(dev, call, reps: int = 10, library=None) -> dict:
    """Device ms by kernel (profiler), CUDA-event ms back to back and of
    one call alone, host enqueue ms of ``call``; with ``library``, that
    call's one-call ms too."""
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
    device = sum(by_kernel.values())
    out = {"device_ms_by_kernel": by_kernel,
           "device_ms": round(device, 4),
           "back_to_back_ms": round(back_to_back, 4),
           "one_call_ms": round(alone, 4),
           "host_enqueue_ms": round(host_ms, 4),
           "host_path_ms": round(alone - device, 4)}
    if library is not None:
        for _ in range(3):
            library()
        out["library_one_call_ms"] = round(statistics.median(
            _events_ms(library, 1) for _ in range(25)), 4)
    return out


def _inputs(dev, shape, dtype):
    B, Hq, Hkv, S, hd = shape
    gen = torch.Generator(device=dev).manual_seed(4)
    return [torch.randn((B, h, S, hd), generator=gen, device=dev).to(dtype)
            for h in (Hq, Hkv, Hkv, Hq)]


def _band(S, causal, window, dev):
    """SDPA's mask of the band, or None where every key is seen."""
    if not causal and not window:
        return None
    i = torch.arange(S, device=dev)
    return ((i[None, :] <= i[:, None]) | (not causal)) & (
        i[:, None] - i[None, :] < (window or S + 1))


def profile_case(dev, shape, causal, window, softcap,
                 dtype=torch.bfloat16) -> dict:
    q, k, v, do = _inputs(dev, shape, dtype)
    out, lse = fa.flash_attention(q, k, v, causal, window, softcap,
                                  return_lse=True)
    library = None
    if not softcap:
        band = _band(shape[3], causal, window, dev)
        lq, lk, lv = (x.detach().requires_grad_(True) for x in (q, k, v))
        lo = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=band,
                                            enable_gqa=True)

        def library():
            torch.autograd.grad(lo, (lq, lk, lv), do, retain_graph=True)
    return time_call(dev, lambda: fa.flash_attention_backward(
        q, k, v, out, do, causal, window, softcap, lse=lse), library=library)


def profile_forward(dev, shape, causal, window, softcap,
                    dtype=torch.float32) -> dict:
    """The forward through ``ops`` (the layer layout, as the models call
    it), beside SDPA's forward on the same inputs."""
    # dense in the layer layout (B, S, H, hd), as the models hold them
    ql, kl, vl = (x.transpose(1, 2).contiguous()
                  for x in _inputs(dev, shape, dtype)[:3])
    q, k, v = (x.transpose(1, 2) for x in (ql, kl, vl))
    band = _band(shape[3], causal, window, dev)
    return time_call(
        dev, lambda: ops.flash_attention(ql, kl, vl, causal=causal,
                                         window=window, softcap=softcap),
        library=None if softcap else lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=band, enable_gqa=True))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", default="bf16,f32",
                    help="comma-separated: bf16, f32")
    ap.add_argument("--forward", action="store_true",
                    help="also the forwards (f32 at phase 4b's shape, bf16 "
                         "at HuBERT's)")
    ap.add_argument("--only", default="",
                    help="only the cases whose name holds this substring")
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
        for case, (shape, causal, window, softcap) in CASES[key].items():
            if args.only in case:
                print(f"backward {key} {case}", json.dumps(profile_case(
                    dev, shape, causal, window, softcap, DTYPES[key])),
                    flush=True)
    if args.forward:
        for case, (shape, causal, window, softcap, dtype) in \
                FORWARD_CASES.items():
            if args.only in case:
                print(f"forward {case}", json.dumps(profile_forward(
                    dev, shape, causal, window, softcap, dtype)), flush=True)


if __name__ == "__main__":
    main()
