"""Fig. 15 (new): sharded save fleet — critical path and bytes vs shards.

The port of ``benchmarks/fig15_sharded_save.py``; its claims and rows are
the reference's.  Decoupling persist per Emb-PS shard means the save-event
critical path (what the training thread blocks on: the host snapshot and
the hand-off) must not grow with the shard count.  ``save_full``'s
critical path is measured on the scaled DLRM for each ``n_shards``,
memory and disk backends, with the flat synchronous store as the
reference, and a fence-time audit that the assembled sharded image equals
the sync store's byte for byte.  Then delta saves (an unchanged re-save
ships 0 bytes), the pipe fleet's shared-memory snapshot path against the
spool file, the socket fleet, the socket codec's wire bytes, the bytes a
writer crash loses with and without XOR parity, and the cost of a
re-admission.

The tables and accumulators live on ``device`` (the reference's numpy
draws, ``common.fleet_state``), as the trainer's do: every save snapshots
them into page-locked host memory, and the delta ledger hashes them where
they lie, through the ``row_hash`` kernel on the card.  Each event is
timed from the call to its return with the device synchronised on both
sides (``common.time_events``); the drain between events is outside the
window.  ``kinds`` (plumbing, default every kind) picks which of the
reference's row kinds to run.
"""
from __future__ import annotations

import tempfile
import time

import numpy as np
import torch

from benchmarks_torch.common import fleet_state, get_config, time_events
from repro_torch import resolve_device
from repro_torch.core.checkpoint import CheckpointStore, EmbShardSpec
from repro_torch.core.sharded_checkpoint import (ShardedCheckpointWriter,
                                                 ShardSaveError)

KINDS = ("save_event", "delta_save", "pipe_snapshot_path",
         "socket_save_event", "socket_wire_bytes", "bytes_lost_at_crash",
         "readmission")


def _same(a_list, b_list) -> bool:
    """Byte-identical images: host arrays or tensors on any device."""
    return all(np.array_equal(_np(a), _np(b)) for a, b in zip(a_list, b_list))


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a


def _bench_shards(sizes, d, n_shards, events, directory, device):
    tables, accs = fleet_state(sizes, d, device=device)
    spec = EmbShardSpec(sizes, n_shards)
    sync = CheckpointStore(tables, accs, spec, directory=directory)
    sync_ms = time_events(
        lambda: sync.save_full(tables, accs, step=0), events, device)
    writer = ShardedCheckpointWriter(
        tables, accs, spec,
        directory=(directory + "-sharded" if directory else None),
        async_save=True, delta_saves=False)
    sharded_ms = time_events(
        lambda: writer.save_full(tables, accs, step=0), events, device,
        after=writer.fence)
    # parity audit: assembled fleet image == sync store image, bit-exact
    wt, wa, _ = writer.restore_all()
    image_matches = (_same(wt, sync.image_tables) and
                     _same(wa, sync.image_accs))
    del wt, wa
    writer.close()
    # the default sharded config keeps delta saves on, whose caller-side
    # row-hash refresh is the one extra critical-path cost
    dwriter = ShardedCheckpointWriter(tables, accs, spec, async_save=True,
                                      delta_saves=True)
    delta_ms = time_events(
        lambda: dwriter.save_full(tables, accs, step=0), events, device,
        after=dwriter.fence)
    dwriter.close()
    return sync_ms, sharded_ms, delta_ms, image_matches


def _bench_transport(sizes, d, n_shards, events, directory, backend, device,
                     **writer_kw):
    """Remote-transport save_full critical path (snapshot + transport
    hand-off) and a post-fence image parity audit vs the flat sync
    store."""
    tables, accs = fleet_state(sizes, d, device=device)
    spec = EmbShardSpec(sizes, n_shards)
    writer = ShardedCheckpointWriter(
        tables, accs, spec, directory=directory, backend=backend,
        delta_saves=False, **writer_kw)
    crit_ms = time_events(
        lambda: writer.save_full(tables, accs, step=0), events, device,
        after=writer.fence)
    sync = CheckpointStore(tables, accs, spec)
    sync.save_full(tables, accs, step=0)
    wt, wa, _ = writer.restore_all()       # one per-shard image fetch
    image_matches = (_same(wt, sync.image_tables) and
                     _same(wa, sync.image_accs))
    writer.close()
    return crit_ms, image_matches


def _bench_readmit(sizes, d, n_shards, directory, device):
    """Cost of re-admitting a killed writer: respawn + reseed + fresh full
    of the shard's rows + the stamping fence."""
    tables, accs = fleet_state(sizes, d, device=device)
    spec = EmbShardSpec(sizes, n_shards)
    writer = ShardedCheckpointWriter(
        tables, accs, spec, directory=directory, backend="pipe",
        delta_saves=False)
    writer.save_full(tables, accs, step=0)
    writer.fence()
    writer.kill_shard(0)
    writer.save_full([t + 1 for t in tables], [a + 1 for a in accs], step=1)
    try:
        writer.fence()
    except ShardSaveError:
        pass                                   # expected: shard 0 poisoned
    t0 = time.perf_counter()
    readmitted = writer.readmit([t + 1 for t in tables],
                                [a + 1 for a in accs], step=2)
    writer.fence()
    readmit_ms = (time.perf_counter() - t0) * 1e3
    ok = bool(readmitted) and not writer.failed
    writer.close()
    return readmit_ms, ok


def _bench_bytes_lost(sizes, d, n_shards, directory, parity_group_size,
                      device):
    """How many bytes of trained state a shard-writer crash costs.

    Stamp a full cycle, drift every row (saved but not stamped: the drain
    is a ``quiesce``, no fence), SIGKILL one writer, then restore its
    shard.  Under stamped replay the shard rolls back to the stamp, so
    every drifted byte in its range is lost; under parity reconstruction
    (``parity_group_size > 0``) the image is rebuilt from the surviving
    peers' data and parity, so the loss is zero.  Returns ``(bytes_lost,
    image_matches_oracle, reconstructions)``, the oracle being the
    trainer's current (drifted) state."""
    dev = resolve_device(device)
    tables, accs = fleet_state(sizes, d, device=dev)
    spec = EmbShardSpec(sizes, n_shards)
    writer = ShardedCheckpointWriter(
        tables, accs, spec, directory=directory, backend="pipe",
        delta_saves=True, parity_group_size=parity_group_size)
    writer.save_full(tables, accs, step=0)
    writer.fence()                          # stamp T0
    rng = np.random.default_rng(7)
    for t, n in enumerate(sizes):           # post-stamp drift, all shards
        noise = rng.normal(size=tuple(tables[t].shape)).astype(np.float32)
        tables[t] = tables[t] + torch.from_numpy(noise).to(dev)
        accs[t] = accs[t] + 1.0
        writer.save_rows(t, torch.arange(n, device=dev), tables[t], accs[t],
                         step=1)
    writer.quiesce()     # applied everywhere, stamped nowhere
    victim = n_shards - 1                   # never a parity holder here
    writer.kill_shard(victim)
    rt = [t.clone() for t in tables]
    ra = [a.clone() for a in accs]
    writer.restore_shards(rt, ra, [victim])
    lost = 0
    exact = True
    for t in range(len(sizes)):
        lo, hi = writer.ranges[victim][t]
        if hi <= lo:
            continue
        lost += int((rt[t][lo:hi] != tables[t][lo:hi]).sum()) * 4
        lost += int((ra[t][lo:hi] != accs[t][lo:hi]).sum()) * 4
        exact = exact and \
            torch.equal(rt[t][lo:hi], tables[t][lo:hi]) and \
            torch.equal(ra[t][lo:hi], accs[t][lo:hi])
    recon = writer.parity_reconstructions
    writer.close()
    return lost, exact, recon


def _bench_delta(sizes, d, n_shards, r, changed_frac, device):
    tables, accs = fleet_state(sizes, d, device=device)
    spec = EmbShardSpec(sizes, n_shards)
    writer = ShardedCheckpointWriter(tables, accs, spec, async_save=True,
                                     delta_saves=True)
    t_big = int(np.argmax(sizes))
    n = sizes[t_big]
    rows = torch.arange(max(1, int(r * n)), device=tables[t_big].device)
    vals = tables[t_big][rows] + 1.0
    avs = accs[t_big][rows] + 1.0
    first = writer.save_rows(t_big, rows, vals, avs, step=0)
    resave = writer.save_rows(t_big, rows, vals, avs, step=1)   # unchanged
    k = max(1, int(changed_frac * rows.numel()))
    vals2 = vals.clone()
    vals2[:k] += 1.0                                            # k rows drift
    partial = writer.save_rows(t_big, rows, vals2, avs, step=2)
    writer.fence()
    writer.close()
    return first, resave, partial, k


def run(max_rows=20_000, n_shards=(1, 2, 4, 8), events=4, r=0.125,
        changed_frac=0.1, lost_shards=None, device=None, kinds=KINDS):
    dev = resolve_device(device)
    cfg = get_config("kaggle", max_rows)
    sizes, d = cfg.table_sizes, cfg.emb_dim
    total = sum(sizes)
    rows = []
    if "save_event" in kinds:
        for n in n_shards:
            for backend in ("memory", "disk"):
                if backend == "disk":
                    with tempfile.TemporaryDirectory() as tmp:
                        sync_ms, sharded_ms, delta_ms, ok = _bench_shards(
                            sizes, d, n, events, tmp + "/ck", dev)
                else:
                    sync_ms, sharded_ms, delta_ms, ok = _bench_shards(
                        sizes, d, n, events, None, dev)
                rows.append({
                    "figure": "fig15", "kind": "save_event",
                    "backend": backend, "n_shards": n, "total_rows": total,
                    "bytes": total * (d + 1) * 4,
                    "sync_crit_ms": round(sync_ms, 3),
                    "sharded_crit_ms": round(sharded_ms, 3),
                    "sharded_delta_on_ms": round(delta_ms, 3),
                    "speedup": round(sync_ms / max(sharded_ms, 1e-9), 2),
                    "image_matches_sync": bool(ok),
                })

    if "delta_save" in kinds:
        for n in n_shards:
            first, resave, partial, k = _bench_delta(sizes, d, n, r,
                                                     changed_frac, dev)
            rows.append({
                "figure": "fig15", "kind": "delta_save", "n_shards": n,
                "first_bytes": first, "unchanged_resave_bytes": resave,
                "changed_rows": k, "partial_resave_bytes": partial,
                "skip_ratio": round(1.0 - resave / max(first, 1), 4),
            })

    # pipe fleet: the spool-file save_full path (one uncompressed .npz
    # disk write on the critical path) vs the shared-memory path (no disk
    # write); the acceptance bar is shm <= spool at every N_emb
    if "pipe_snapshot_path" in kinds:
        for n in n_shards:
            with tempfile.TemporaryDirectory() as tmp:
                spool_ms, ok_spool = _bench_transport(
                    sizes, d, n, events, tmp + "/spool", "pipe", dev,
                    snapshot="spool")
                shm_ms, ok_shm = _bench_transport(
                    sizes, d, n, events, tmp + "/shm", "pipe", dev,
                    snapshot="shm")
            rows.append({
                "figure": "fig15", "kind": "pipe_snapshot_path",
                "backend": "disk", "n_shards": n, "total_rows": total,
                "spool_crit_ms": round(spool_ms, 3),
                "shm_crit_ms": round(shm_ms, 3),
                "shm_speedup": round(spool_ms / max(shm_ms, 1e-9), 2),
                "shm_not_slower": bool(shm_ms <= spool_ms),
                "image_matches_sync": bool(ok_spool and ok_shm),
            })

    # socket fleet: the same protocol over TCP (an auto-spawned loopback
    # shard_server per shard); the submit cost is the hand-off to the
    # per-shard sender threads, which slice and pack off the critical path
    if "socket_save_event" in kinds:
        for n in n_shards:
            with tempfile.TemporaryDirectory() as tmp:
                sock_ms, ok = _bench_transport(sizes, d, n, events,
                                               tmp + "/ck", "socket", dev)
            rows.append({
                "figure": "fig15", "kind": "socket_save_event",
                "backend": "disk", "n_shards": n, "total_rows": total,
                "socket_crit_ms": round(sock_ms, 3),
                "image_matches_sync": bool(ok),
            })

    # raw-vs-wire bytes over the socket fleet with the negotiated zlib
    # codec on: the per-frame compression must shrink the wire side of the
    # same save traffic
    if "socket_wire_bytes" in kinds:
        n = max(n_shards)
        # float16-quantized values give zlib real redundancy to find
        tables, accs = fleet_state(sizes, d, device=dev)
        tables = [t.to(torch.float16).to(torch.float32) for t in tables]
        spec = EmbShardSpec(sizes, n)
        writer = ShardedCheckpointWriter(
            tables, accs, spec, backend="socket", delta_saves=False,
            transport_options={"codec_level": 6, "shm_handoff": False})
        writer.save_full(tables, accs, step=0)
        writer.fence()
        wire = writer.wire_stats
        writer.close()
        rows.append({
            "figure": "fig15", "kind": "socket_wire_bytes", "n_shards": n,
            "codec_level": 6, "raw_sent": wire["raw_sent"],
            "wire_sent": wire["wire_sent"],
            "wire_ratio": round(wire["wire_sent"] /
                                max(wire["raw_sent"], 1), 4),
            "compressed_fewer_bytes": bool(wire["wire_sent"] <
                                           wire["raw_sent"]),
        })

    # bytes lost to a writer crash: stamped replay rolls the shard back to
    # its last stamped cycle; XOR parity across peer writers reconstructs
    # the current image from survivors.  The bar: parity strictly below
    # stamped at every N_emb, the reconstructed shard equal to the oracle
    if "bytes_lost_at_crash" in kinds:
        for n in (n_shards if lost_shards is None else lost_shards):
            if n < 2:
                continue                 # parity needs at least one peer
            with tempfile.TemporaryDirectory() as tmp:
                stamped_lost, _, _ = _bench_bytes_lost(
                    sizes, d, n, tmp + "/stamped", 0, dev)
                parity_lost, exact, recon = _bench_bytes_lost(
                    sizes, d, n, tmp + "/parity", 2, dev)
            rows.append({
                "figure": "fig15", "kind": "bytes_lost_at_crash",
                "n_shards": n, "total_rows": total,
                "stamped_replay_lost_bytes": stamped_lost,
                "parity_reconstruct_lost_bytes": parity_lost,
                "parity_strictly_below": bool(parity_lost < stamped_lost),
                "parity_image_matches_oracle": bool(exact),
                "parity_reconstructions": recon,
            })

    # re-admission cost at the largest fleet size benchmarked
    if "readmission" in kinds:
        n = max(n_shards)
        with tempfile.TemporaryDirectory() as tmp:
            readmit_ms, ok = _bench_readmit(sizes, d, n, tmp + "/ck", dev)
        rows.append({
            "figure": "fig15", "kind": "readmission", "n_shards": n,
            "readmit_fence_ms": round(readmit_ms, 3), "readmit_ok": bool(ok),
        })
    return rows
