"""gemma2-2b's production train step on the host mesh, at a chosen batch
and microbatch count: its time and its memory, or where it runs out.

    PYTHONPATH=src python -m repro_torch.launch.profile_mesh \\
        [--batch 16] [--seq 4096] [--microbatches 4] [--steps 3] \\
        [--expandable-segments] [--serve]

Runs ``chip_smoke.py`` phase 8 (a)'s train step alone: the reference's
``build_train_step`` (Adam, bf16 forward) through ``shard_train_step`` on
``launch.mesh.make_host_mesh()`` (NCCL, a world of one) at full width and
depth, ``--steps`` steps.  Prints ms a step, the peak allocated and
reserved memory, and the launches of the attention kernels; where the
step runs out of the card's memory, the allocator's numbers at that
point, and exits with 3.  ``--expandable-segments`` turns the caching
allocator's expandable segments on before the first allocation.
``--serve`` then times the prefill step at (2, 4096) and the serve step
at batch 4 for 16 steps, as phase 8 (a) does, with nothing else running
on the host.  Needs a GPU.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from repro_torch import kernels, resolve_device
from repro_torch.configs import get_config

ARCH = "gemma2-2b"


def _gb(n: int) -> str:
    return f"{n / 1e9:.2f}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--expandable-segments", action="store_true")
    ap.add_argument("--serve", action="store_true")
    args = ap.parse_args(argv)
    if args.expandable_segments:
        torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    import torch.distributed as dist

    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import get_optimizer
    from repro_torch.sharding import specs as S

    dev = resolve_device("cuda")
    cfg = get_config(ARCH)
    mesh = M.make_host_mesh()
    B, Sq, mb = args.batch, args.seq, args.microbatches
    print(f"{torch.cuda.get_device_name(0)}; {cfg.name} at full width and "
          f"depth, train step {B} x {Sq} tokens, {mb} microbatches, Adam, "
          f"bf16 forward, expandable_segments={args.expandable_segments}")
    fn, _, _, p_sp, o_sp = ST.build_train_step(
        cfg, mesh, optimizer="adam", bf16_forward=True, microbatches=mb)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = T.init_model(cfg, gen, dev)
    opt = get_optimizer("adam", 3e-4).init(params)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, Sq), device=dev,
                                     generator=gen, dtype=torch.int32)}
    params = S.shard_tree(params, p_sp, mesh)
    opt = S.shard_tree(opt, o_sp, mesh)
    step = ST.shard_train_step(fn, mesh, p_sp, o_sp,
                               S.lm_input_specs(batch, mesh))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    times, losses = [], []
    try:
        for _ in range(args.steps):
            t0 = time.perf_counter()
            params, opt, met = step(params, opt, batch)
            losses.append(float(met["loss"]))
            times.append((time.perf_counter() - t0) * 1e3)
    except torch.cuda.OutOfMemoryError as e:
        print(f"out of memory at step {len(times)}: allocated "
              f"{_gb(torch.cuda.memory_allocated())} GB, reserved "
              f"{_gb(torch.cuda.memory_reserved())} GB, peak allocated "
              f"{_gb(torch.cuda.max_memory_allocated())} GB, peak reserved "
              f"{_gb(torch.cuda.max_memory_reserved())} GB; "
              f"{str(e).splitlines()[0]}")
        dist.destroy_process_group()
        return 3
    print(f"ms a step {', '.join(f'{t:.1f}' for t in times)} (the first "
          f"with warm-up); peak allocated "
          f"{_gb(torch.cuda.max_memory_allocated())} GB, peak reserved "
          f"{_gb(torch.cuda.max_memory_reserved())} GB of "
          f"{_gb(M.hbm_bytes(dev))} GB; losses "
          f"{', '.join(f'{v:.4f}' for v in losses)}")
    print(f"launches {json.dumps(dict(kernels.LAUNCHES))}")
    if args.serve:
        del opt, met
        torch.cuda.empty_cache()
        prefill, _, _ = ST.build_prefill_step(cfg, mesh)
        toks = {"tokens": batch["tokens"][:2, :Sq]}
        with torch.no_grad():
            prefill(params, toks)
            ms = []
            for _ in range(3):
                t0 = time.perf_counter()
                prefill(params, toks)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
        print(f"prefill step 2 x {Sq}: ms {', '.join(f'{t:.1f}' for t in ms)}")
        serve, _, _, _, _ = ST.build_serve_step(cfg, mesh, "decode_32k")
        state = T.init_decode_state(cfg, 4, Sq, device=dev)
        tok = batch["tokens"][:4, 0]
        ms = []
        with torch.no_grad():
            for pos in range(16):
                t0 = time.perf_counter()
                logits, state = serve(params, state, tok, pos)
                tok = logits.argmax(-1).to(torch.int32)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
        print(f"serve step batch 4, 16 steps: ms a step median "
              f"{statistics.median(ms[1:]):.2f} (each "
              f"{', '.join(f'{t:.1f}' for t in ms)})")
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
