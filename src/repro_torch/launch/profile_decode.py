"""Times gemma2-2b's plain and sharded serve steps, and profiles one.

The plain step against the sharded one on the host mesh, and where a
step over long_500k's whole cache spends its device time.

    PYTHONPATH=src python -m repro_torch.launch.profile_decode [--long]
    PYTHONPATH=build/parent/src python src/repro_torch/launch/profile_decode.py

At full width and depth on ``launch.mesh.make_host_mesh()`` (NCCL, a
world of one): ``build_serve_step`` at batch 4 over a 4,096-slot cache,
``--rounds`` rounds of 16 steps, each round the plain step and then the
one through ``shard_serve_step`` (where the tree on ``PYTHONPATH`` has
it: run this file by path under a parent tree for a same-call A/B).
Prints the median and range of ms a step (the first step of a round
left out).  ``--long`` then serves long_500k (``profile_mesh.serve_long``:
batch 1, the whole 524,288-slot cache) and runs one more step under
``torch.profiler``: its device time by kernel.  Needs a GPU.
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time

import torch

ARCH = "gemma2-2b"
BATCH, CACHE, STEPS = 4, 4096, 16


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--long", action="store_true")
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.sharding import specs as S

    dev = torch.device("cuda")
    cfg = get_config(ARCH)
    mesh = M.make_host_mesh()
    params = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    fn, _, _, p_sp, _ = ST.build_serve_step(cfg, mesh, "decode_32k")
    kinds = ["plain"] + (["sharded"] if hasattr(ST, "shard_serve_step")
                         else [])
    ms = {k: [] for k in kinds}
    with torch.no_grad():
        for _ in range(args.rounds):
            for name in kinds:
                state = T.init_decode_state(cfg, BATCH, CACHE, device=dev)
                step = fn if name == "plain" else ST.shard_serve_step(
                    fn, mesh, p_sp, S.decode_state_specs(state, cfg, mesh,
                                                         BATCH))
                tok = torch.zeros(BATCH, dtype=torch.int32, device=dev)
                for pos in range(STEPS):
                    t0 = time.perf_counter()
                    logits, state = step(params, state, tok, pos)
                    tok = logits.argmax(-1).to(torch.int32)
                    torch.cuda.synchronize()
                    if pos:
                        ms[name].append((time.perf_counter() - t0) * 1e3)
                del state
    for name, v in ms.items():
        print(f"{args.label} {name} serve step, batch {BATCH}: median "
              f"{statistics.median(v):.2f} ms, {min(v):.2f}-{max(v):.2f} over "
              f"{len(v)} steps", flush=True)
    if args.long:
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.launch.profile_mesh import serve_long
        torch.cuda.empty_cache()
        steps, peak, finite, state = serve_long(cfg, mesh, params, dev,
                                                steps=4)
        step = ST.shard_serve_step(fn, mesh, p_sp, S.decode_state_specs(
            state, cfg, mesh, 1))
        tok = torch.zeros(1, dtype=torch.int32, device=dev)
        W = state["stages"][1]["k"].shape[2]
        with torch.no_grad(), profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(params, state, tok, W - 1)
            torch.cuda.synchronize()
        print(f"long_500k: ms a step {', '.join(f'{t:.1f}' for t in steps)}; "
              f"peak {peak / 1e9:.2f} GB; finite={finite}; one step at pos "
              f"{W - 1:,} by device time:")
        print(prof.key_averages().table(sort_by="cuda_time_total",
                                        row_limit=12,
                                        max_name_column_width=60))
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
