"""Production-mesh dry run on the H100's numbers (the port of
``repro.launch.dryrun``).

For one (arch x input-shape x mesh), or all of them:
  1. the memory of one rank of the production mesh: ``argument_bytes``
     and ``output_bytes`` summed from the specs over the structs (each
     leaf's shard), ``temp_bytes`` the peak of ``MemTracker`` over the
     rank's step run on fake tensors (below); gradient-accumulation
     microbatches doubled until the step fits the H100's 80 GB, as the
     reference does against the v5e's 16 GiB;
  2. on one pod, the 1- and 2-repetition probes, whose counted flops,
     bytes and collective bytes (``launch.roofline``) are extrapolated to
     the full depth;
  3. a JSON record under ``artifacts/dryrun_torch/``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b \\
        --shape train_4k [--multipod] [--no-probes] [--reduced] \\
        [--out artifacts/dryrun_torch]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

The process starts a fake process group (``torch.distributed``'s "fake"
backend) of 256 or 512 ranks and runs as its rank 0, on fake CPU tensors
(``FakeTensorMode``): nothing is allocated, no collective moves data, and
no kernel launches (a CPU tensor takes the plain versions).  Run it in a
process of its own: it leaves its process group up.

The rank's step is what the port runs there, on the rank's shards: the
train step under ``steps.shard_train_step``, the prefill and serve steps
under ``steps.shard_prefill_step`` and ``steps.shard_serve_step`` (the
weights gathered a layer at a time, the logits the rank's vocabulary
slice; the serve step attends over the rank's piece of each KV cache and
merges the pieces), so ``temp_bytes`` is the rank's own and
``collectives_full`` holds the weight gathers and the attention merges.
The serve step runs at position 0.  The plain versions' attention keeps
(B, H, S, S) f32 scores, so a ``temp_bytes`` with full-sequence attention
is an upper bound on the kernels'.  The
port's train step updates the parameters in place and builds the new
optimizer state during the step: ``temp_bytes`` holds that state, and
``total_bytes`` is ``argument_bytes + temp_bytes``.

Renamed keys of the reference's record: ``fits_16GiB`` -> ``fits_80GB``,
``compile_s`` -> ``trace_s``, ``collectives_full_hlo`` ->
``collectives_full`` (the counter's bytes over the full-depth step),
``cost_analysis_raw`` -> ``cost_counts``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import torch

from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.configs.base import ATTN, LOCAL_ATTN, MOE
from repro_torch.launch import mesh as M
from repro_torch.launch import roofline as R
from repro_torch.launch import steps as ST
from repro_torch.sharding import collectives as coll
from repro_torch.sharding import specs as S
from repro_torch.sharding.ctx import activation_sharding
from repro_torch.tree import leaves, tree_map

CHIP = {"name": "NVIDIA H100 SXM5 80GB (data sheet)",
        "peak_flops_bf16": M.PEAK_FLOPS_BF16, "hbm_bw": M.HBM_BW,
        "nvlink_bw": M.NVLINK_BW, "ib_bw": M.IB_BW,
        "gpus_per_node": M.GPUS_PER_NODE, "hbm_bytes": M.CHIP_HBM_BYTES}


def applicable(arch: str, shape_name: str):
    """(runs?, variant, reason): the reference's skip policy."""
    cfg = get_config(arch)
    shp = INPUT_SHAPES[shape_name]
    if shp.kind == "decode" and not cfg.supports_decode:
        return False, None, "encoder-only: no decode step"
    if shape_name == "long_500k":
        kinds = set(cfg.layer_kinds)
        unbounded = (ATTN in kinds or MOE in kinds)
        if unbounded and cfg.sliding_window == 0:
            # dense/MoE full attention: run the sliding-window variant
            return True, "sw4096", "full attention at 500k KV: sliding-window variant"
        if ATTN in kinds:  # gemma2 global layers: model-sharded KV cache
            return True, None, "global layers use sharded 500k KV cache"
    return True, None, ""


def variant_config(cfg, variant):
    if variant == "sw4096":
        pattern = tuple(LOCAL_ATTN if k in (ATTN,) else k
                        for k in cfg.block_pattern)
        return dataclasses.replace(cfg, block_pattern=pattern,
                                   sliding_window=4096,
                                   name=cfg.name + "-sw4096")
    return cfg


def probe_cfg(cfg, reps: int):
    """A config of ``reps`` pattern repetitions."""
    return dataclasses.replace(
        cfg, num_layers=reps * len(cfg.block_pattern),
        block_pattern=cfg.block_pattern * reps,
        name=f"{cfg.name}-probe{reps}")


def start_fake_world(world: int) -> None:
    """A fake process group of ``world`` ranks; this process is rank 0."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def spec_bytes(structs, specs, mesh) -> int:
    """The bytes of a rank's shards of ``structs`` under ``specs``."""
    total = 0
    for s, sp in zip(leaves(structs), leaves(specs)):
        n = 1
        for d in S.local_shape(s.shape, sp, mesh):
            n *= d
        total += n * s.element_size()
    return total


def _local(structs, specs, mesh):
    """Fake tensors of a rank's shards (in the active fake mode)."""
    return tree_map(lambda s, sp: torch.zeros(S.local_shape(s.shape, sp, mesh),
                                              dtype=s.dtype),
                    structs, specs)


def _dp_size(mesh):
    sizes = S.axis_sizes(mesh)
    return sizes.get("data", 1) * sizes.get("pod", 1)


def build_step(cfg, shape_name: str, mesh, opt="adam", microbatches=1):
    """The step of a (cfg, shape) pair on ``mesh`` with its structs and
    specs, and its spec-derived memory -> (kind, fn, structs, specs,
    argument_bytes, output_bytes); structs and specs are dicts by role
    (``params``, ``opt``, ``state``, ``batch``)."""
    shp = INPUT_SHAPES[shape_name]
    dp = S.batch_axes(mesh)
    batch = ST.batch_struct(cfg, shape_name)
    B = shp.global_batch
    bdp = dp if B % _dp_size(mesh) == 0 else None
    bf16 = getattr(torch, cfg.dtype)
    st, sp = {"batch": batch}, {"batch": S.lm_input_specs(batch, mesh)}
    if shp.kind == "train":
        fn, st["params"], st["opt"], sp["params"], sp["opt"] = \
            ST.build_train_step(cfg, mesh, optimizer=opt,
                                param_dtype=torch.float32,
                                microbatches=microbatches)
        outs = (spec_bytes(st["params"], sp["params"], mesh)
                + spec_bytes(st["opt"], sp["opt"], mesh) + 3 * 4)
    elif shp.kind == "prefill":
        fn, st["params"], sp["params"] = ST.build_prefill_step(
            cfg, mesh, param_dtype=bf16)
        shape = (B, shp.seq_len, cfg.vocab_size)
        outs = _struct_bytes(S.local_shape(
            shape, S.logits_spec(mesh, shape), mesh), bf16)
    else:  # decode
        fn, st["params"], st["state"], sp["params"], sp["state"] = \
            ST.build_serve_step(cfg, mesh, shape_name, param_dtype=bf16)
        sp["batch"] = {"tokens": S.P(bdp) if bdp else S.P()}
        shape = (B, cfg.vocab_size)
        outs = spec_bytes(st["state"], sp["state"], mesh) + _struct_bytes(
            S.local_shape(shape, S.logits_spec(mesh, shape), mesh), bf16)
    args = sum(spec_bytes(st[k], sp[k], mesh) for k in st)
    return shp.kind, fn, st, sp, args, outs


def _struct_bytes(shape, dtype) -> int:
    return _nbytes(torch.empty(shape, dtype=dtype, device="meta"))


def argument_bytes(cfg, shape_name: str, mesh, opt="adam") -> int:
    """A rank's argument bytes of the pair's step (from the specs)."""
    return build_step(cfg, shape_name, mesh, opt)[4]


def lower_one(cfg, shape_name: str, mesh, opt="adam", probe=False,
              microbatches=1, count=False):
    """Run the rank's step once on fake tensors -> {"argument_bytes",
    "output_bytes", "temp_bytes", "collectives"} and, with ``count``, the
    counted ``flops`` and ``bytes accessed`` (instead of ``temp_bytes``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    shp = INPUT_SHAPES[shape_name]
    batch_sharded = shp.global_batch % _dp_size(mesh) == 0
    kind, fn, st, sp, args, outs = build_step(cfg, shape_name, mesh, opt,
                                              microbatches)
    mode = FakeTensorMode(allow_non_fake_inputs=False)
    out = {"argument_bytes": args, "output_bytes": outs}
    with mode, activation_sharding(mesh, probe_full_blocks=probe,
                                   batch_sharded=batch_sharded):
        lb = _local(st["batch"], sp["batch"], mesh)
        if kind == "train":
            lp = _local(st["params"], sp["params"], mesh)
            lo = _local(st["opt"], sp["opt"], mesh)
            step = ST.shard_train_step(fn, mesh, sp["params"], sp["opt"],
                                       sp["batch"])

            def run():
                step(lp, lo, lb)
        elif kind == "prefill":
            lp = _local(st["params"], sp["params"], mesh)
            step = ST.shard_prefill_step(fn, mesh, sp["params"], sp["batch"])

            def run():
                with torch.no_grad():
                    step(lp, lb)
        else:
            lp = _local(st["params"], sp["params"], mesh)
            ls = _local(st["state"], sp["state"], mesh)
            step = ST.shard_serve_step(fn, mesh, sp["params"], sp["state"])

            def run():
                with torch.no_grad():
                    step(lp, ls, lb["tokens"], 0)

        coll.reset_counts()
        if count:
            flops, nbytes = FlopCounterMode(display=False), R.BytesCounter()
            with flops, nbytes:
                run()
            out["flops"] = float(flops.get_total_flops())
            out["bytes accessed"] = float(nbytes.bytes)
        else:
            mt = MemTracker()
            with mt:
                run()
            peak = mt.get_tracker_snapshot("peak")
            out["temp_bytes"] = int(sum(v["Total"] for v in peak.values()))
        out["collectives"] = coll.counts()
    return out


def run_pair(arch: str, shape_name: str, multi_pod: bool, probes: bool,
             reduced: bool = False):
    t0 = time.monotonic()               # duration timer, not a timestamp
    runs, variant, reason = applicable(arch, shape_name)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "variant": variant, "note": reason, "status": "skipped",
           "chip": CHIP}
    if not runs:
        return rec
    cfg = variant_config(get_config(arch), variant)
    if reduced:
        cfg = cfg.reduced()
        rec["reduced"] = True
    mesh = M.make_production_mesh(multi_pod=multi_pod, device="cpu")
    chips = int(mesh.size())
    shp = INPUT_SHAPES[shape_name]

    # ---- the full-depth step: memory; microbatches doubled until the
    # train step fits (the global batch must stay divisible)
    microbatches = 1
    while True:
        full = lower_one(cfg, shape_name, mesh, microbatches=microbatches)
        total = full["argument_bytes"] + full["temp_bytes"]
        if (shp.kind != "train" or total <= M.CHIP_HBM_BYTES
                or microbatches >= 8
                or shp.global_batch % (microbatches * 2)):
            break
        microbatches *= 2
    rec["microbatches"] = microbatches
    rec.update({
        "status": "ok",
        "trace_s": round(time.monotonic() - t0, 1),
        "memory": {
            "argument_bytes": full["argument_bytes"],
            "output_bytes": full["output_bytes"],
            "temp_bytes": full["temp_bytes"],
            "total_bytes": total,
            "fits_80GB": bool(total <= M.CHIP_HBM_BYTES),
        },
        "collectives_full": full["collectives"],
    })

    # ---- probes for the roofline (one pod only) ----
    if probes and not multi_pod:
        P_len = len(cfg.block_pattern)
        n_reps = cfg.num_layers // P_len
        rem = cfg.num_layers - n_reps * P_len
        c1 = lower_one(probe_cfg(cfg, 1), shape_name, mesh, probe=True,
                       count=True)
        c2 = (lower_one(probe_cfg(cfg, 2), shape_name, mesh, probe=True,
                        count=True) if n_reps >= 2 or rem else c1)
        cost = [{k: c[k] for k in ("flops", "bytes accessed")}
                for c in (c1, c2)]
        link = M.collective_link(max(S.axis_sizes(mesh).values()))
        terms = R.extrapolate(cost[0], cost[1], c1["collectives"],
                              c2["collectives"], n_reps, rem, P_len, chips,
                              R.analytic_model_flops(cfg, shp), link)
        rec["roofline"] = terms.as_dict()
        rec["cost_counts"] = cost[0]
        rec["probe_cost"] = {"p1": cost[0], "p2": cost[1],
                             "coll1": c1["collectives"],
                             "coll2": c2["collectives"]}
    rec["wall_s"] = round(time.monotonic() - t0, 1)
    return rec


def artifact_path(out_dir, arch, shape_name, mesh_name):
    os.makedirs(out_dir, exist_ok=True)
    return os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}.json")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs())
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--probes", action="store_true", default=None)
    ap.add_argument("--no-probes", dest="probes", action="store_false")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced() config (a quick check)")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args(argv)

    pairs = ([(a, s) for a in list_archs() for s in INPUT_SHAPES]
             if args.all else [(args.arch, args.shape)])
    start_fake_world(512 if args.multipod else 256)
    failures = 0
    for arch, shape_name in pairs:
        mesh_name = "pod2x16x16" if args.multipod else "pod16x16"
        probes = args.probes if args.probes is not None else not args.multipod
        try:
            rec = run_pair(arch, shape_name, args.multipod, probes,
                           args.reduced)
        except Exception as e:  # record the failure; the sweep continues
            rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                   "status": "error", "error": repr(e),
                   "traceback": traceback.format_exc()}
            failures += 1
        with open(artifact_path(args.out, arch, shape_name, mesh_name),
                  "w") as f:
            json.dump(rec, f, indent=1)
        print(json.dumps({k: rec.get(k) for k in
                          ("arch", "shape", "mesh", "status", "note",
                           "trace_s")}), flush=True)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
