"""Where HuBERT X-Large's forward and training step spend their device time.

    PYTHONPATH=src python -m repro_torch.launch.profile_encoder \\
        [--warmup 2] [--steps 2] [--top 15]

Draws ``hubert-xlarge`` at full width and depth on the card (f32
parameters, bf16 activations) and runs ``chip_smoke.py`` phase 3h's
workload (whose constants and batch it defines): (8, 1000) frame
embeddings, masked prediction over HuBERT's span mask, the loss's
backward and the port's ``adam`` (no remat).  After
``--warmup`` steps it wraps one forward, then ``--steps`` training steps,
each in ``torch.profiler`` (CPU and CUDA activities), and prints for each
window its host ms, device-busy share and device time by kernel name.
Needs a GPU.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import adam, apply_updates
from repro_torch.tree import leaves, unflatten

ARCH = "hubert-xlarge"
BATCH, FRAMES = 8, 1000
SPAN, SPAN_START = 10, 0.08     # HuBERT's pretraining mask
LR = 1e-4


def span_mask(rng, B: int, S: int) -> np.ndarray:
    """HuBERT's pretraining mask (f32 0/1): each frame starts a masked span
    of SPAN frames with probability SPAN_START (about half the frames)."""
    starts = rng.random((B, S)) < SPAN_START
    mask = np.zeros((B, S), bool)
    for off in range(SPAN):
        mask[:, off:] |= starts[:, :S - off]
    return mask.astype(np.float32)


def make_batch(cfg, B: int, S: int, seed: int, device) -> dict:
    """Frame embeddings, targets and a span mask from a numpy seed."""
    rng = np.random.default_rng(seed)
    return {"embeds": torch.from_numpy(rng.normal(
                size=(B, S, cfg.d_model)).astype(np.float32)).to(device),
            "targets": torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (B, S))).to(device),
            "target_mask": torch.from_numpy(span_mask(rng, B, S)).to(device)}


def _report(name, prof, wall_s, n, top):
    rows = sorted(((e.key, e.self_device_time_total, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows) / 1e3
    print(f"{name}: {wall_s * 1e3 / n:.3f} ms each (host clock, profiled), "
          f"device busy {busy_ms / n:.3f} ms ({100 * busy_ms / wall_s / 1e3:.1f}"
          f" %), {sum(r[2] for r in rows) / n:.0f} device operations each")
    print(f"{'device ms':>10} {'calls':>8}  kernel")
    for key, us, count in rows[:top]:
        print(f"{us / 1e3 / n:10.3f} {count / n:8.1f}  {key[:110]}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    cfg = get_config(ARCH)
    params = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    batch = make_batch(cfg, BATCH, FRAMES, 1, dev)
    opt = adam(LR)
    state = opt.init(params)
    flat = leaves(params)
    for t in flat:
        t.requires_grad_(True)

    def step():
        nonlocal state
        loss, _ = T.lm_loss(params, batch, cfg)
        grads = torch.autograd.grad(loss, flat)
        updates, state = opt.update(unflatten(params, grads), state, params)
        apply_updates(params, updates)

    def forward():
        with torch.no_grad():
            T.forward(params, {"embeds": batch["embeds"]}, cfg)

    for _ in range(args.warmup):
        forward()
        step()
    torch.cuda.synchronize(dev)
    print(f"{torch.cuda.get_device_name(0)}; {ARCH} at full width and depth "
          f"(f32 parameters, bf16 activations), ({BATCH}, {FRAMES}) frames, "
          f"Adam, no remat; after {args.warmup} warm-up steps")
    for name, fn, n in (("forward", forward, 1),
                        ("training step", step, args.steps)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
        _report(name, prof, wall, n, args.top)


if __name__ == "__main__":
    main()
