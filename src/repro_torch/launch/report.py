"""Render the port's dry-run records as markdown tables (the port of
``repro.launch.report``).

  PYTHONPATH=src python -m repro_torch.launch.report [--dir artifacts/dryrun_torch]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.mesh import (CHIP_HBM_BYTES, HBM_BW, IB_BW,
                                     NVLINK_BW, PEAK_FLOPS_BF16)


def load(pattern):
    out = []
    for f in sorted(glob.glob(pattern)):
        with open(f) as fh:
            out.append(json.load(fh))
    return out


def fmt_bytes(b):
    return f"{b / 1e9:.1f}"


def dryrun_table(recs):
    lines = ["| arch | shape | mesh | status | microbatches | HBM GB/GPU | "
             "fits 80 GB | note |",
             "|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r["status"] == "ok":
            m = r["memory"]
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | "
                f"{r.get('microbatches', 1)} | {fmt_bytes(m['total_bytes'])} | "
                f"{'✓' if m['fits_80GB'] else '✗'} | {r.get('note', '')} |")
        else:
            note = r.get("note") or r.get("error", "")[:60]
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                         f"{r['status']} | — | — | — | {note} |")
    return "\n".join(lines)


def roofline_table(recs):
    lines = ["| arch | shape | t_comp s | t_mem s | t_coll s | link | "
             "bottleneck | MODEL_FLOPS/counted |",
             "|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r["status"] != "ok" or "roofline" not in r:
            continue
        t = r["roofline"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {t['t_compute_s']:.3f} | "
            f"{t['t_memory_s']:.3f} | {t['t_collective_s']:.3f} | "
            f"{t['collective_link']} | **{t['bottleneck']}** | "
            f"{t['useful_flops_ratio']:.3f} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)
    pod = load(os.path.join(args.dir, "*pod16x16.json"))
    multi = load(os.path.join(args.dir, "*pod2x16x16.json"))

    print("# Dry run of the port on H100 meshes\n")
    print(f"Generated by `python -m repro_torch.launch.report` from "
          f"`{args.dir}/*.json`. Model estimates on one rank of the mesh, "
          f"from the NVIDIA H100 SXM5 data sheet's constants: "
          f"{PEAK_FLOPS_BF16 / 1e12:.0f} TFLOP/s bf16 dense, "
          f"{HBM_BW / 1e12:.2f} TB/s HBM3, {CHIP_HBM_BYTES / 1e9:.0f} GB, "
          f"NVLink 4 {NVLINK_BW / 1e9:.0f} GB/s and InfiniBand "
          f"{IB_BW / 1e9:.0f} GB/s each way per GPU; not measurements.\n")
    print("## Memory\n")
    print(f"Single pod (16×16 = 256 GPUs): {len(pod)} records; two pods "
          f"(2×16×16 = 512 GPUs): {len(multi)} records.\n")
    print("### Single pod\n")
    print(dryrun_table(pod))
    print("\n### Two pods\n")
    print(dryrun_table(multi))
    print("\n## Roofline (single pod, per GPU)\n")
    print("1- and 2-repetition probes extrapolated to the full depth; flops "
          "are the counted products of the plain versions, bytes every "
          "operation's operands and outputs unfused, collective bytes the "
          "port's counter.\n")
    print(roofline_table(pod))


if __name__ == "__main__":
    main()
