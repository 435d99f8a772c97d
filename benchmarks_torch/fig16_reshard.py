"""Fig. 16 (new): elastic reshard pause vs stop-and-restart resize.

The port of ``benchmarks/fig16_reshard.py``; its claim and rows are the
reference's.  ``ShardedCheckpointWriter.resize(..., block=False)`` changes
the writer-fleet size on a helper thread (fence the old layout, stream
row ranges between writers, swap retained writers' stores in place,
enqueue seed fulls) while the trainer keeps stepping; the layout epoch
stamps with the next natural fence.  The trainer-visible pause is the
launch plus the join.  The alternative is a stop-and-restart resize:
close the fleet, cold-replay the event chain from disk
(``load_latest_auto``), bring up a fresh fleet under the new layout and
re-persist a full.  Both are measured for a split (2 -> 4) and a merge
(4 -> 3) on the scaled DLRM, per transport, with a byte-parity audit of
the post-reshard image against a flat synchronous oracle fed the same
traffic.

The trainer's tables live on ``device``; the traffic's draws
(``rng.choice``, ``rng.normal``) stay numpy, in the reference's order, and
its rows go to the fleet and the oracle as device tensors.  While the
reshard runs, ``_compute_step`` does a step's embedding work on the
device and waits for it, so ``steps_during_reshard`` counts finished
steps.
"""
from __future__ import annotations

import tempfile
import threading
import time

import numpy as np
import torch

from benchmarks_torch.common import fleet_state, get_config, sync
from repro_torch import resolve_device
from repro_torch.core.checkpoint import CheckpointStore, EmbShardSpec
from repro_torch.core.sharded_checkpoint import (ShardedCheckpointWriter,
                                                 load_latest_auto)


def _traffic(savers, sizes, d, state_t, state_a, rng, n_ops, step0=0):
    dev = state_t[0].device
    for k in range(step0, step0 + n_ops):
        if k % 3 == 0:
            for t in range(len(sizes)):
                state_t[t] = state_t[t] + np.float32(rng.normal())
                state_a[t] = state_a[t] + np.float32(abs(rng.normal()))
            for s in savers:
                s.save_full(state_t, state_a, step=k)
        else:
            t = int(np.argmax(sizes))
            rows = rng.choice(sizes[t], size=max(1, sizes[t] // 8),
                              replace=False)
            vals = rng.normal(size=(rows.size, d)).astype(np.float32)
            avs = rng.random(rows.size).astype(np.float32)
            rows, vals, avs = (torch.from_numpy(x).to(dev)
                               for x in (rows, vals, avs))
            state_t[t] = state_t[t].clone()
            state_a[t] = state_a[t].clone()
            state_t[t][rows] = vals
            state_a[t][rows] = avs
            for s in savers:
                s.save_rows(t, rows, vals, avs, step=k)


def _compute_step(sizes, d, state_t, state_a, rng):
    """One trainer step's worth of embedding work (lookup + sparse
    update) on the tables' device, touching local state only: no
    checkpoint traffic.  This is what the trainer does while a background
    reshard is in flight: saves wait for the join, compute does not."""
    t = int(np.argmax(sizes))
    rows = torch.from_numpy(rng.choice(sizes[t], size=max(1, sizes[t] // 16),
                                       replace=False)).to(state_t[t].device)
    grad = torch.tanh(state_t[t][rows]) * 0.01
    state_t[t] = state_t[t].clone()
    state_a[t] = state_a[t].clone()
    state_t[t][rows] -= grad
    state_a[t][rows] += grad.square().mean(dim=1)
    sync(state_t[t].device)


def _same(fleet, oracle_t, oracle_a) -> bool:
    return all(np.array_equal(a, b.cpu().numpy() if
                              isinstance(b, torch.Tensor) else b)
               for a, b in list(zip(fleet.image_tables, oracle_t)) +
               list(zip(fleet.image_accs, oracle_a)))


def _bench_live(sizes, d, directory, backend, n_from, n_to, n_ops, device):
    """Online resize under traffic with the non-blocking protocol: the
    reshard streams rows on a helper thread, the trainer keeps stepping,
    and the trainer-visible pause is launch + join; the layout stamp rides
    the next natural fence."""
    tables, accs = fleet_state(sizes, d, device=device)
    oracle = CheckpointStore(tables, accs, EmbShardSpec(sizes, 1))
    fleet = ShardedCheckpointWriter(
        tables, accs, EmbShardSpec(sizes, n_from), directory=directory,
        backend=backend, delta_saves=False)
    rng = np.random.default_rng(1)
    state_t, state_a = list(tables), list(accs)
    _traffic([fleet, oracle], sizes, d, state_t, state_a, rng, n_ops)
    box = {}

    def work():
        box["info"] = fleet.resize(n_to, step=n_ops, block=False)
    th = threading.Thread(target=work, name="fig16-resize")
    t0 = time.perf_counter()
    th.start()
    launch_s = time.perf_counter() - t0
    steps = 0
    while th.is_alive():
        _compute_step(sizes, d, state_t, state_a, rng)
        steps += 1
    t1 = time.perf_counter()
    th.join()
    join_s = time.perf_counter() - t1
    if "info" not in box:
        raise RuntimeError("background resize failed")
    moved = box["info"]["moved_bytes"]
    # saves resume at the next boundary; the first fence after the
    # reshard stamps the layout epoch with a normal cycle
    _traffic([fleet, oracle], sizes, d, state_t, state_a, rng, n_ops,
             step0=n_ops + 1)
    fleet.fence()
    ok = _same(fleet, oracle.image_tables, oracle.image_accs)
    fleet.close()
    return launch_s + join_s, moved, ok, steps


def _bench_restart(sizes, d, directory, backend, n_from, n_to, n_ops,
                   device):
    """The pre-elastic alternative: stop the fleet, cold-replay the chain,
    bring up a fresh fleet under the new layout, re-persist a seed full.
    The timed window is everything the trainer would wait on."""
    tables, accs = fleet_state(sizes, d, device=device)
    fleet = ShardedCheckpointWriter(
        tables, accs, EmbShardSpec(sizes, n_from),
        directory=directory + "-old", backend=backend, delta_saves=False)
    rng = np.random.default_rng(1)
    state_t, state_a = list(tables), list(accs)
    _traffic([fleet], sizes, d, state_t, state_a, rng, n_ops)
    fleet.fence()
    t0 = time.perf_counter()
    fleet.close()
    loaded = load_latest_auto(directory + "-old", tables, accs,
                              EmbShardSpec(sizes, n_from))
    lt, la, _ = loaded.restore_all()
    fresh = ShardedCheckpointWriter(
        lt, la, EmbShardSpec(sizes, n_to), directory=directory + "-new",
        backend=backend, delta_saves=False)
    fresh.save_full(lt, la, step=n_ops)
    fresh.fence()
    restart_s = time.perf_counter() - t0
    ok = _same(fresh, state_t, state_a)
    fresh.close()
    return restart_s, ok


def run(max_rows=20_000, backends=("inproc", "pipe"),
        transitions=((2, 4), (4, 3)), n_ops=6, device=None):
    dev = resolve_device(device)
    cfg = get_config("kaggle", max_rows)
    sizes, d = cfg.table_sizes, cfg.emb_dim
    rows = []
    for backend in backends:
        for n_from, n_to in transitions:
            with tempfile.TemporaryDirectory() as tmp:
                pause_s, moved, ok_live, steps = _bench_live(
                    sizes, d, tmp + "/live", backend, n_from, n_to, n_ops,
                    dev)
                restart_s, ok_restart = _bench_restart(
                    sizes, d, tmp + "/cold", backend, n_from, n_to, n_ops,
                    dev)
            speedup = restart_s / max(pause_s, 1e-9)
            rows.append({
                "figure": "fig16", "kind": "reshard", "backend": backend,
                "from_shards": n_from, "to_shards": n_to,
                "total_rows": sum(sizes),
                "live_pause_ms": round(pause_s * 1e3, 3),
                "steps_during_reshard": steps,
                "moved_mb": round(moved / 1e6, 3),
                "restart_ms": round(restart_s * 1e3, 3),
                "speedup": round(speedup, 2),
                "live_10x_faster": bool(speedup >= 10.0),
                "image_matches_oracle": bool(ok_live and ok_restart),
            })
    return rows
