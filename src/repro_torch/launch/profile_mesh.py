"""gemma2-2b's production train step on the host mesh, at a chosen batch
and microbatch count: its time and its memory, or where it runs out; then,
optionally, its sharded prefill and serve steps.

    PYTHONPATH=src python -m repro_torch.launch.profile_mesh \\
        [--batch 16] [--seq 4096] [--microbatches 4] [--steps 3] \\
        [--expandable-segments] [--serve] [--long]

Runs ``chip_smoke.py`` phase 8 (a)'s train step alone: the reference's
``build_train_step`` (Adam, bf16 forward) through ``shard_train_step`` on
``launch.mesh.make_host_mesh()`` (NCCL, a world of one) at full width and
depth, ``--steps`` steps.  Prints ms a step, the peak allocated and
reserved memory, and the launches of the attention kernels; where the
step runs out of the card's memory, the allocator's numbers at that
point, and exits with 3.  ``--expandable-segments`` turns the caching
allocator's expandable segments on before the first allocation.
``--serve`` then times the prefill step at (2, 4096) and the serve step
at batch 4 for 16 steps through ``shard_prefill_step`` and
``shard_serve_step``, as phase 8 (a) does, with nothing else running on
the host.  ``--long`` serves long_500k on the one card (``serve_long``:
batch 1, the whole 524,288-slot cache, filled with random bf16 keys and
values, 16 steps at its last positions) and checks the attention merge at
the production mesh's piece size (``merge_check``), as phase 8 (d) does.
Needs a GPU.
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
LONG = "long_500k"
LONG_STEPS = 16
# pod16x16 splits long_500k's cache over ("data", "model"): 256 pieces
MERGE_PIECES = 256


def serve_long(cfg, mesh, params, dev, steps: int = LONG_STEPS):
    """``steps`` serve steps of ``cfg`` at long_500k's batch and length on
    ``mesh`` (the host mesh: the whole cache on the one rank), through
    ``shard_serve_step``, at the cache's last positions; every cache slot
    holds random bf16 keys and values (the ring and the global layers
    alike) -> (ms a step, the peak allocated bytes, whether the logits
    are finite, the state)."""
    from repro_torch.configs import INPUT_SHAPES
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.sharding import specs as S
    from repro_torch.tree import leaves

    shp = INPUT_SHAPES[LONG]
    B, W = shp.global_batch, shp.seq_len
    serve, _, _, p_sp, _ = ST.build_serve_step(cfg, mesh, LONG)
    gen = torch.Generator(device=dev).manual_seed(1)
    state = T.init_decode_state(cfg, B, W, device=dev)
    for t in leaves(state):
        t.normal_(generator=gen)
    step = ST.shard_serve_step(serve, mesh, p_sp,
                               S.decode_state_specs(state, cfg, mesh, B))
    tok = torch.randint(0, cfg.vocab_size, (B,), device=dev, generator=gen,
                        dtype=torch.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, finite = [], True
    with torch.no_grad():
        for pos in range(W - steps, W):
            t0 = time.perf_counter()
            logits, state = step(params, state, tok, pos)
            tok = logits.argmax(-1).to(torch.int32)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            finite &= bool(torch.isfinite(logits).all())
    return ms, torch.cuda.max_memory_allocated(), finite, state


def merge_check(cfg, k, v, q, pos: int, pieces: int = MERGE_PIECES):
    """One global layer's attention of ``q`` (B, 1, Hq, hd) over its whole
    cache ``k``, ``v`` (B, W, kv, hd) at ``pos``, in f32: the partial
    attention over each of ``pieces`` equal pieces merged by
    ``merge_pieces`` (what ``merge_attention`` does after its all-gather)
    against the one-piece result -> (largest difference over the largest
    entry, how many pieces hold no valid slot)."""
    from repro_torch.models import layers as L
    from repro_torch.sharding import collectives as coll

    B, W = k.shape[:2]
    valid = torch.arange(W, device=k.device) <= pos
    mask = valid[None, None].expand(B, 1, W)
    whole, _ = L.partial_attention(q, k, v, mask, cfg.attn_softcap)
    n = W // pieces
    outs, lses = [], []
    for i in range(pieces):
        sl = slice(i * n, (i + 1) * n)
        o, lse = L.partial_attention(q, k[:, sl], v[:, sl], mask[..., sl],
                                     cfg.attn_softcap)
        outs.append(o)
        lses.append(lse)
    got = coll.merge_pieces(torch.stack(outs), torch.stack(lses))
    err = float((got - whole).abs().max() / whole.abs().max())
    empty = int((~valid.reshape(pieces, n).any(-1)).sum())
    return err, empty


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
    ap.add_argument("--long", action="store_true")
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
    del opt, met
    torch.cuda.empty_cache()
    if args.serve:
        prefill, _, p_sp = ST.build_prefill_step(cfg, mesh)
        toks = {"tokens": batch["tokens"][:2, :Sq]}
        prefill = ST.shard_prefill_step(prefill, mesh, p_sp,
                                        S.lm_input_specs(toks, mesh))
        with torch.no_grad():
            prefill(params, toks)
            ms = []
            for _ in range(3):
                t0 = time.perf_counter()
                prefill(params, toks)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
        print(f"prefill step 2 x {Sq}: ms {', '.join(f'{t:.1f}' for t in ms)}")
        serve, _, _, p_sp, _ = ST.build_serve_step(cfg, mesh, "decode_32k")
        state = T.init_decode_state(cfg, 4, Sq, device=dev)
        serve = ST.shard_serve_step(serve, mesh, p_sp, S.decode_state_specs(
            state, cfg, mesh, 4))
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
        del state
    if args.long:
        torch.cuda.empty_cache()
        ms, peak, finite, state = serve_long(cfg, mesh, params, dev)
        print(f"{LONG} serve step, batch 1, the whole cache on one card: ms "
              f"a step median {statistics.median(ms[1:]):.2f} (each "
              f"{', '.join(f'{t:.1f}' for t in ms)}); peak allocated "
              f"{_gb(peak)} GB; finite={finite}")
        glob = state["stages"][1]            # (LOCAL_ATTN, ATTN): global
        k, v = glob["k"][0], glob["v"][0]
        q = torch.randn((1, 1, cfg.num_heads, cfg.head_dim), device=dev,
                        dtype=k.dtype)
        for pos in (k.shape[1] - 1, k.shape[1] * 3 // 8):
            err, empty = merge_check(cfg, k, v, q, pos)
            print(f"merge of {MERGE_PIECES} pieces at pos {pos:,} "
                  f"({empty} empty): {err:.3e} of the largest")
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
