"""Shared benchmark infrastructure: cached dataset + one-call emulation,
the fleet figures' cached table state and their device-synchronised
event timer.

The port of ``benchmarks/common.py``.  ``run_emulation``'s keyword-only
arguments (device, tracker backend, table scale, step cap, initial
parameters) are plumbing: their defaults reproduce the reference's call.
"""
from __future__ import annotations

import functools
import subprocess
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.dlrm import DLRM_KAGGLE, DLRM_TERABYTE, scaled
from repro_torch.core import (CPRManager, Emulator, FailureInjector,
                              SystemParams)
from repro_torch.data.synthetic import ClickLogDataset

MAX_ROWS = 20_000
NUM_SAMPLES = 40_000
BATCH = 512


def get_config(name: str = "kaggle", max_rows=None):
    """The config with the tables scaled so that the largest has
    ``max_rows`` rows (``MAX_ROWS`` when None); a ``max_rows`` at least
    the largest table's keeps the published config (``scaled`` would
    raise its tables of fewer than 4 rows to 4)."""
    cfg = DLRM_KAGGLE if name == "kaggle" else DLRM_TERABYTE
    max_rows = max_rows or MAX_ROWS
    if max(cfg.table_sizes) > max_rows:
        cfg = scaled(cfg, max_rows=max_rows)
    return cfg


@functools.lru_cache(maxsize=4)
def get_dataset(name: str = "kaggle", seed: int = 3, max_rows=None):
    """(config, dataset) of ``get_config(name, max_rows)``."""
    cfg = get_config(name, max_rows)
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


def time_events(save_fn, events, device, after=None) -> float:
    """Per-event critical-path ms (median over ``events`` timed calls),
    each read after the device has finished the event's work; ``after``
    runs between events (a drain), outside the timed window."""
    out = []
    for _ in range(events):
        sync(device)
        t0 = time.perf_counter()
        save_fn()
        sync(device)
        out.append((time.perf_counter() - t0) * 1e3)
        if after is not None:
            after()
    return float(np.median(out))


@functools.lru_cache(maxsize=1)
def _drawn(sizes, d, seed, quantized):
    rng = np.random.default_rng(seed)
    if quantized:
        tables = [rng.normal(size=(n, d)).astype(np.float16)
                  .astype(np.float32) for n in sizes]
        accs = [np.abs(rng.normal(size=n)).astype(np.float16)
                .astype(np.float32) for n in sizes]
    else:
        tables = [rng.normal(size=(n, d)).astype(np.float32) for n in sizes]
        accs = [np.zeros(n, np.float32) for n in sizes]
    return tables, accs


@functools.lru_cache(maxsize=2)
def _fleet_state(sizes, d, seed, quantized, dev):
    tables, accs = _drawn(sizes, d, seed, quantized)
    return (tuple(torch.as_tensor(t, device=dev) for t in tables),
            tuple(torch.as_tensor(a, device=dev) for a in accs))


def fleet_state(sizes, d, seed=0, *, quantized=False, device=None):
    """The fleet figures' (tables, accs) on ``device``, drawn with numpy
    exactly as the reference's ``_state`` of fig15 and fig16 does (f32
    normals, zero accumulators) or, ``quantized``, fig17's (float16-rounded
    normals and absolute normals).  Drawn once per (sizes, d, seed, kind)
    and put on each device once (on the CPU the tensors share the drawn
    arrays' memory); shared: callers get fresh lists and must not write
    into the tensors."""
    tables, accs = _fleet_state(tuple(sizes), d, seed, quantized,
                                resolve_device(device))
    return list(tables), list(accs)


def clear_fleet_state() -> None:
    """Drop the cached fleet state (and the memory it holds)."""
    _fleet_state.cache_clear()
    _drawn.cache_clear()


def csv_row(name, us_per_call, derived):
    return f"{name},{us_per_call},{derived}"
