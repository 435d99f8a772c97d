"""Benchmark harness of the port: one module per paper table/figure.

Usage:
  PYTHONPATH=src python -m benchmarks_torch.run [--only fig7,fig13] [--fast]
      [--device cuda|cpu]

Runs on ``cuda`` unless ``--device cpu`` is given, and raises without a
GPU.  Prints ``name,us_per_call,derived`` CSV lines (one per benchmark
row; the ``derived`` field is the row's JSON payload) and writes
``artifacts/bench_torch/<name>.json``: the reference's rows, each with a
``"device"`` field (``nvidia-smi``'s name and power limit of the card, or
``"cpu"``).  Timing fields are the device's own and are never compared
with another device's.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import time

from benchmarks_torch.common import device_label
from repro_torch import resolve_device

OUT_DIR = os.path.join("artifacts", "bench_torch")

BENCHMARKS = [
    ("fig3", "benchmarks_torch.fig3_failure_model", {}),
    ("fig6", "benchmarks_torch.fig6_freq_update_corr", {}),
    ("fig7", "benchmarks_torch.fig7_overhead", {}),
    ("fig8", "benchmarks_torch.fig8_production", {}),
    ("fig9", "benchmarks_torch.fig9_pls_sensitivity", {}),
    ("fig10", "benchmarks_torch.fig10_failures", {}),
    ("fig11", "benchmarks_torch.fig11_pls_accuracy", {}),
    ("fig12", "benchmarks_torch.fig12_ssu_slope", {}),
    ("fig13", "benchmarks_torch.fig13_scalability", {}),
    ("fig14", "benchmarks_torch.fig14_async_save", {}),
    ("fig15", "benchmarks_torch.fig15_sharded_save", {}),
    ("fig16", "benchmarks_torch.fig16_reshard", {}),
    ("fig17", "benchmarks_torch.fig17_wire", {}),
    ("table1", "benchmarks_torch.table1_trackers", {}),
]
ANALYTIC = {"fig3", "fig13"}        # numpy only: no device argument

FAST_OVERRIDES = {
    "fig7": {"datasets": ("kaggle",)},
    "fig11": {"n_points": 6},
    "fig10": {"n_failures": (2, 20)},
    "fig14": {"max_rows": (20_000,), "events": 3,
              "select_sizes": (50_000,)},
    # lost_shards keeps the bytes_lost_at_crash parity-vs-stamped audit
    # (kill a writer, reconstruct from peers) in the fast run
    "fig15": {"max_rows": 8_000, "n_shards": (1, 2, 4), "events": 3,
              "lost_shards": (2, 4)},
    "fig16": {"max_rows": 6_000, "n_ops": 3},
    "fig17": {"max_rows": 6_000, "events": 3, "hash_rows": 20_000},
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="")
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    only = set(args.only.split(",")) if args.only else None
    device = resolve_device(args.device)
    label = device_label(device)

    os.makedirs(OUT_DIR, exist_ok=True)
    print("name,us_per_call,derived")
    for name, module, kwargs in BENCHMARKS:
        if only and name not in only:
            continue
        kw = dict(kwargs)
        if args.fast and name in FAST_OVERRIDES:
            kw.update(FAST_OVERRIDES[name])
        if name not in ANALYTIC:
            kw["device"] = device
        mod = importlib.import_module(module)
        t0 = time.perf_counter()
        rows = [{**row, "device": label} for row in mod.run(**kw)]
        us = (time.perf_counter() - t0) * 1e6 / max(len(rows), 1)
        with open(os.path.join(OUT_DIR, f"{name}.json"), "w") as f:
            json.dump(rows, f, indent=1)
        for row in rows:
            print(f"{name},{us:.0f},{json.dumps(row)}", flush=True)


if __name__ == "__main__":
    main()
