"""The RG-LRU scan kernels on the card: checks, times and what they compiled to.

    PYTHONPATH=src python -m repro_torch.launch.profile_scan [--sass DIR]

At the shapes of ``chip_smoke.py`` phases 2b and 2c (the backward at the
training path's (8, 512, 2560) and at (2, 4096, 2560), the forward at
(2, 4096, 2560), f32 and bf16), prints for each: whether the kernel
equals its plain version (``torch.equal``), the device time per call by
kernel (``torch.profiler``, 10 calls), the CUDA-event time per call over
50 calls back to back and of one call alone (median of 25), the host time
to enqueue a call, and the bound (the bytes the function moves over 3.35
TB/s).  First the card's name and power limit and the scan libraries'
registers, shared memory and spills (``ptxas -v``, from the build's log).
``--sass DIR`` writes each scan library's SASS into DIR and prints, by
kernel, how many global and shared loads and stores of each width it
holds.  Needs a GPU.

Run by path against another tree's package (``PYTHONPATH=<tree>/src
python src/repro_torch/launch/profile_scan.py``), it times that tree's
kernels: the same-call A/B of a change.
"""
from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
from pathlib import Path

import torch

from repro_torch import resolve_device
from repro_torch.kernels import _build, ref
from repro_torch.kernels import rglru_scan as rg
from repro_torch.launch.profile_attention_backward import time_call

HBM_BYTES_PER_S = 3.35e12
SHAPES = {"backward": ((8, 512, 2560), (2, 4096, 2560)),
          "forward": ((2, 4096, 2560),)}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
LIBS = ("rglru_scan", "rglru_scan_backward")
MEMORY_OP = re.compile(r"\b(LDGSTS|LDG|STG|LDS|STS)(\.[A-Z0-9.]+)?")


def _inputs(dev, shape, dtype):
    gen = torch.Generator(device=dev).manual_seed(4)
    a = torch.sigmoid(torch.randn(shape, generator=gen, device=dev)
                      ).to(dtype)
    b = (torch.randn(shape, generator=gen, device=dev) * 0.1).to(dtype)
    dh = torch.randn(shape, generator=gen, device=dev).to(dtype)
    return a, b, dh


def profile_case(dev, which, shape, dtype) -> dict:
    a, b, dh = _inputs(dev, shape, dtype)
    h = rg.rglru_scan(a, b)
    if which == "forward":
        equal = torch.equal(h, ref.rglru_scan(a, b))
        call, streams = (lambda: rg.rglru_scan(a, b)), 3
    else:
        got = rg.rglru_scan_backward(a, h, dh)
        again = rg.rglru_scan_backward(a, h, dh)
        equal = all(torch.equal(x, y) and torch.equal(x, z) for x, y, z in
                    zip(got, ref.rglru_scan_backward(a, h, dh), again))
        call, streams = (lambda: rg.rglru_scan_backward(a, h, dh)), 5
    bound = streams * a.numel() * a.element_size() / HBM_BYTES_PER_S * 1e3
    out = {"equal_to_plain": equal, **time_call(dev, call),
           "bound_ms": round(bound, 5)}
    out["share_of_bound"] = round(bound / out["one_call_ms"], 3)
    return out


def memory_ops(sass: str) -> dict:
    """Global and shared loads and stores of each width, by function."""
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = collections.Counter()
        elif fn is not None:
            m = MEMORY_OP.search(line)
            if m:
                counts[fn][m.group(0)] += 1
    return {f: dict(sorted(c.items())) for f, c in counts.items()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sass", metavar="DIR",
                    help="write the scan libraries' SASS here and count "
                         "their memory instructions")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    out_dir = _build.build_all()
    for lib in LIBS:
        for line in (out_dir / f"lib{lib}.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"{lib}: {line.strip()}")
    if args.sass:
        sass_dir = Path(args.sass)
        sass_dir.mkdir(parents=True, exist_ok=True)
        cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
        for lib in LIBS:
            sass = subprocess.run(
                [str(cuobjdump), "-sass", str(out_dir / f"lib{lib}.so")],
                capture_output=True, text=True, check=True).stdout
            (sass_dir / f"{lib}.sass").write_text(sass)
            for fn, ops in memory_ops(sass).items():
                print(f"{lib}: {fn}: {json.dumps(ops)}")
    for which, shapes in SHAPES.items():
        for shape in shapes:
            for key, dtype in DTYPES.items():
                print(f"{which} {key} {shape}", json.dumps(
                    profile_case(dev, which, shape, dtype)), flush=True)


if __name__ == "__main__":
    main()
