"""The f32 attention backward against an f64 backward, and its time.

    PYTHONPATH=src python -m repro_torch.launch.check_attention_backward \
        [--only hd80]

At the Qwen models' prefill shapes (head dim 128: MHA 16:16 and qwen3's
GQA 32:4 at 4,096 tokens, the GQA at 1,024 and 2,048 as well), the
training check 7 (b)'s (1, 10:1, 2176, 256) with window 2,048 and
HuBERT's bidirectional head dim 80 ((1, 16, 1000, 80), 4h (a)'s, and (2,
16, 4096, 80), longer runs; ``--only hd80`` runs these two), draws q,
k, v and dO from a seeded generator and computes dQ, dK, dV three ways:
the backward kernel (given the forward's log-sum-exp, as ``ops`` hands
it), the plain f32 backward (``kernels.ref``) and an f64 backward written
out here.  Prints, for each gradient, its largest share of the f32 limit
|x - exact| <= 1e-4 |exact| + 1e-5 max |exact| for the kernel and for the
plain version, both against the f64 one (the exact gradient to f32's
precision), and the kernel's one-call time (CUDA events, median of 15).
Prints the card's name and power limit first.  Needs a GPU.

Run by path against another tree's package (``PYTHONPATH=<tree>/src
python src/repro_torch/launch/check_attention_backward.py``), it checks
and times that tree's kernel: the same-call A/B of a change.
"""
from __future__ import annotations

import argparse
import math
import statistics
import subprocess

import torch

from repro_torch import resolve_device
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

# (B, Hq, Hkv, S, hd), window, causal
CASES = (((2, 16, 16, 4096, 128), 0, True),
         ((1, 32, 4, 4096, 128), 0, True),
         ((1, 32, 4, 2048, 128), 0, True),
         ((1, 32, 4, 1024, 128), 0, True),
         ((1, 10, 1, 2176, 256), 2048, True),
         ((1, 16, 16, 1000, 80), 0, False),
         ((2, 16, 16, 4096, 80), 0, False))
RTOL, ATOL = 1e-4, 1e-5       # chip_smoke.py's BWD_TOL for f32


def f64_backward(q, k, v, dout, window, causal=True):
    """dQ, dK, dV of causal attention (``window`` keys back when set) or
    bidirectional attention in f64, from f32 inputs (B, H, S, hd)."""
    q, k, v, dout = (x.double() for x in (q, k, v, dout))
    B, Hq, S, hd = q.shape
    g = Hq // k.shape[1]
    kq, vq = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    i = torch.arange(S, device=q.device)
    keep = (i[None, :] <= i[:, None]) | (not causal)
    if window:
        keep &= (i[:, None] - i[None, :]) < window
    s = torch.einsum("bhsd,bhtd->bhst", q, kq) / math.sqrt(hd)
    p = torch.softmax(torch.where(keep, s, -math.inf), -1)
    del s
    o = p @ vq
    dv = p.transpose(-1, -2) @ dout
    ds = p * (dout @ vq.transpose(-1, -2) - (dout * o).sum(-1, keepdim=True))
    del p
    dq = ds @ kq / math.sqrt(hd)
    dk = ds.transpose(-1, -2) @ q / math.sqrt(hd)
    return (dq, dk.reshape(B, -1, g, S, hd).sum(2),
            dv.reshape(B, -1, g, S, hd).sum(2))


def share(got, exact):
    """The largest ratio of |got - exact| to the f32 limit."""
    limit = RTOL * exact.abs() + ATOL * exact.abs().max()
    return ((got.double() - exact).abs() / limit).max().item()


def one_call_ms(fn, reps: int = 15) -> float:
    for _ in range(3):
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


def main() -> None:
    dev = resolve_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("hd80",), default=None,
                    help="only HuBERT's head-dim-80 bidirectional shapes")
    args = ap.parse_args()
    for (B, Hq, Hkv, S, hd), window, causal in CASES:
        if args.only and hd != 80:
            continue
        g = torch.Generator(device=dev).manual_seed(S + hd)
        q, k, v, dout = (torch.randn((B, h, S, hd), generator=g, device=dev)
                         for h in (Hq, Hkv, Hkv, Hq))
        out, lse = fa.flash_attention(q, k, v, causal, window, 0.0,
                                      return_lse=True)

        def kernel():
            return fa.flash_attention_backward(q, k, v, out, dout, causal,
                                               window, 0.0, lse=lse)

        got = kernel()
        plain = ref.flash_attention_backward(q, k, v, out, dout, causal,
                                             window, 0.0)
        exact = f64_backward(q, k, v, dout, window, causal)
        shares = ", ".join(
            f"{name} kernel {share(a, x):.3f} plain {share(b, x):.3f}"
            for name, a, b, x in zip(("dQ", "dK", "dV"), got, plain, exact))
        print(f"f32 backward ({B}, {Hq}:{Hkv}, {S}, {hd}) window={window} "
              f"causal={causal}: "
              f"share of the f32 limit against f64: {shares}; one call "
              f"{one_call_ms(kernel):.4f} ms", flush=True)
        del got, plain, exact
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
