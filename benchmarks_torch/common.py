"""Shared benchmark infrastructure: cached dataset + one-call emulation.

The port of ``benchmarks/common.py``.  ``run_emulation``'s keyword-only
arguments (device, tracker backend, table scale, step cap, initial
parameters) are plumbing: their defaults reproduce the reference's call.
"""
from __future__ import annotations

import functools
import subprocess
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs.dlrm import DLRM_KAGGLE, DLRM_TERABYTE, scaled
from repro_torch.core import (CPRManager, Emulator, FailureInjector,
                              SystemParams)
from repro_torch.data.synthetic import ClickLogDataset

MAX_ROWS = 20_000
NUM_SAMPLES = 40_000
BATCH = 512


@functools.lru_cache(maxsize=4)
def get_dataset(name: str = "kaggle", seed: int = 3, max_rows=None):
    """(config, dataset) with the tables scaled so that the largest has
    ``max_rows`` rows (``MAX_ROWS`` when None); a ``max_rows`` at least
    the largest table's keeps the published config."""
    cfg = DLRM_KAGGLE if name == "kaggle" else DLRM_TERABYTE
    max_rows = max_rows or MAX_ROWS
    if max(cfg.table_sizes) > max_rows:
        cfg = scaled(cfg, max_rows=max_rows)
    ds = ClickLogDataset(cfg.table_sizes, num_samples=NUM_SAMPLES, seed=seed)
    return cfg, ds


def run_emulation(mode: str, dataset="kaggle", target_pls=0.1, n_failures=2,
                  fraction=0.25, seed=3, fail_seed=11,
                  sys_params: SystemParams | None = None,
                  t_save_override: float | None = None, eval_frac=0.1, *,
                  device=None, tracker_backend="host", max_rows=None,
                  max_steps=None, init_params=None):
    cfg, ds = get_dataset(dataset, seed, max_rows)
    p = sys_params or SystemParams()
    mgr = CPRManager(mode, p, cfg.table_sizes, target_pls=target_pls,
                     tracker_backend=tracker_backend, device=device)
    if t_save_override is not None:
        mgr.T_save = t_save_override
    inj = FailureInjector(n_failures=n_failures, fail_fraction=fraction,
                          n_shards=p.N_emb, T_total=p.T_total, seed=fail_seed)
    t0 = time.time()
    res = Emulator(cfg, ds, mgr, inj, batch_size=BATCH, eval_frac=eval_frac,
                   device=device, init_params=init_params).run(
        max_steps=max_steps)
    res.report["wall_s"] = time.time() - t0
    return res


def device_label(device=None) -> str:
    """What a row's ``"device"`` field says: ``nvidia-smi``'s name and
    power limit of the card, or ``"cpu"``."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         f"--id={dev.index or 0}"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def sync(device) -> None:
    """Wait for the device's queued work (a no-op on the CPU): clocks read
    after it time the work, not its launch."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def csv_row(name, us_per_call, derived):
    return f"{name},{us_per_call},{derived}"
