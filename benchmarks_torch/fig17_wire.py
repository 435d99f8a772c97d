"""Fig. 17 (new): data-plane wire efficiency — mux, codec, shm handoff,
and the row-hash kernel.

The port of ``benchmarks/fig17_wire.py``; its rows and audit fields are
the reference's:

  * ``mux_save_event``: several shards multiplexed over one socket
    connection and server vs one connection per shard; the save-event
    critical path (submit + fence) within 1.5x of the per-connection
    fleet's (min over events), with fewer server processes.
  * ``compressed_reshard``: a fleet resize streams every moved row through
    ``export_rows`` responses and re-import saves; with the zlib codec
    those frames cost strictly fewer wire bytes, with the same image.
  * ``shm_full_handoff``: co-hosted servers receive ``save_full`` as a
    shared-memory segment name instead of streamed row slices.
  * ``hash_kernel``: the CUDA FNV-1a row hash (``csrc/row_hash.cu``)
    against the plain version on the host (``ref.row_hash`` on CPU
    tensors, in the place of the reference's numpy loop), timed on a big
    slice (CUDA events on the card, the host clock on the CPU) and audited
    bit for bit on every shape class of the reference's, zero rows and
    zero-byte rows included.

The fleet rows save from tables on ``device`` (``common.fleet_state``,
the reference's draws).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmarks_torch.common import fleet_state, sync
from repro_torch import resolve_device
from repro_torch.core.checkpoint import CheckpointStore, EmbShardSpec
from repro_torch.core.sharded_checkpoint import ShardedCheckpointWriter
from repro_torch.kernels import ops, ref


def _state(sizes, d, device):
    """Compressible trained-looking state: float16-quantized normals give
    zlib real redundancy (pure float32 noise is incompressible)."""
    return fleet_state(sizes, d, quantized=True, device=device)


def _min_event_ms(writer, tables, accs, events, device):
    """Min-over-events durable save latency (submit + fence)."""
    out = []
    for i in range(events):
        sync(device)
        t0 = time.perf_counter()
        writer.save_full(tables, accs, step=i)
        writer.fence()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.min(out))


def _image_matches(writer, sync_store):
    wt, wa, _ = writer.restore_all()
    return all(np.array_equal(a, b) for a, b in
               list(zip(wt, sync_store.image_tables)) +
               list(zip(wa, sync_store.image_accs)))


def _bench_mux(sizes, d, n_shards, group, events, device):
    tables, accs = _state(sizes, d, device)
    spec = EmbShardSpec(sizes, n_shards)
    store = CheckpointStore(tables, accs, spec)
    store.save_full(tables, accs, step=events - 1)
    res = {}
    for label, opts in (("per_conn", {}),
                        ("mux", {"mux_group": group})):
        writer = ShardedCheckpointWriter(
            tables, accs, spec, backend="socket", delta_saves=False,
            transport_options=opts)
        ms = _min_event_ms(writer, tables, accs, events, device)
        ok = _image_matches(writer, store)
        pids = {ep.pid for ep in writer.transport.endpoints}
        writer.close()
        res[label] = (ms, ok, len(pids))
    return res


def _bench_reshard(sizes, d, n_from, n_to, codec_level, device):
    tables, accs = _state(sizes, d, device)
    spec = EmbShardSpec(sizes, n_from)
    opts = {"codec_level": codec_level} if codec_level else {}
    writer = ShardedCheckpointWriter(
        tables, accs, spec, backend="socket", delta_saves=False,
        transport_options=opts)
    writer.save_full(tables, accs, step=0)
    writer.fence()
    # grow resize: donor shards reshard in place, so the export/import
    # stream rides connections whose byte counters survive to be read
    writer.resize(n_to, step=1)
    wire = writer.wire_stats
    wt, wa, _ = writer.restore_all()
    writer.close()
    return wire, wt, wa


def _bench_shm(sizes, d, n_shards, events, device):
    tables, accs = _state(sizes, d, device)
    spec = EmbShardSpec(sizes, n_shards)
    store = CheckpointStore(tables, accs, spec)
    store.save_full(tables, accs, step=events - 1)
    res = {}
    for label, handoff in (("streamed", False), ("shm", True)):
        writer = ShardedCheckpointWriter(
            tables, accs, spec, backend="socket", delta_saves=False,
            transport_options={"shm_handoff": handoff})
        ms = _min_event_ms(writer, tables, accs, events, device)
        ok = _image_matches(writer, store)
        wire = writer.wire_stats
        shm_on = all(getattr(ep, "shm_ok", False)
                     for ep in writer.transport.endpoints)
        writer.close()
        res[label] = (ms, ok, wire, shm_on)
    return res


def _bench_hash(n_rows, d, trials, device):
    """(plain ms on the host, kernel ms on ``device``, bit-exact on every
    shape class).  The inputs are the reference's draws."""
    dev = resolve_device(device)
    rng = np.random.default_rng(3)
    vals = torch.from_numpy(rng.normal(size=(n_rows, d)).astype(np.float32))
    avs = torch.from_numpy(np.abs(rng.normal(size=n_rows)).astype(np.float32))
    vals_d, avs_d = vals.to(dev), avs.to(dev)

    def best_ms(fn, *args):
        fn(*args)                           # warm (build, caches)
        times = []
        for _ in range(trials):
            if dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(*args)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                fn(*args)
                times.append((time.perf_counter() - t0) * 1e3)
        return min(times)

    host_ms = best_ms(ref.row_hash, vals, avs)
    kern_ms = best_ms(ops.row_hash, vals_d, avs_d)
    # bit-exactness over every shape class a shard slice can take,
    # including the empty slice (a shard owning zero rows of a table) and
    # zero-byte rows
    exact = True
    for n, dd in ((0, 8), (1, 1), (7, 3), (257, 5), (n_rows, d)):
        v = torch.from_numpy(rng.normal(size=(n, dd)).astype(np.float32))
        a = torch.from_numpy(np.abs(rng.normal(size=n)).astype(np.float32))
        got = ops.row_hash(v.to(dev), a.to(dev)).cpu()
        exact = exact and torch.equal(got, ref.row_hash(v, a))
    v0 = torch.zeros((4, 0))                # zero-byte rows
    a0 = torch.zeros((4, 0))
    exact = exact and torch.equal(ops.row_hash(v0.to(dev), a0.to(dev)).cpu(),
                                  ref.row_hash(v0, a0))
    return host_ms, kern_ms, bool(exact)


def run(max_rows=20_000, d=16, n_shards=4, mux_group=2, events=4,
        codec_level=6, reshard_to=None, hash_rows=50_000, hash_trials=3,
        device=None):
    dev = resolve_device(device)
    sizes = (max_rows, max_rows // 2, max_rows // 4)
    reshard_to = reshard_to or n_shards * 2
    rows = []

    # ---- mux vs one-connection-per-shard --------------------------------
    mux = _bench_mux(sizes, d, n_shards, mux_group, events, dev)
    per_ms, per_ok, per_servers = mux["per_conn"]
    mux_ms, mux_ok, mux_servers = mux["mux"]
    rows.append({
        "figure": "fig17", "kind": "mux_save_event", "n_shards": n_shards,
        "mux_group": mux_group,
        "per_conn_ms": round(per_ms, 3), "mux_ms": round(mux_ms, 3),
        "per_conn_servers": per_servers, "mux_servers": mux_servers,
        "mux_fewer_servers": bool(mux_servers < per_servers),
        "mux_not_slower": bool(mux_ms <= per_ms * 1.5),
        "image_matches_sync": bool(per_ok and mux_ok),
    })

    # ---- compressed vs raw reshard stream -------------------------------
    raw_wire, raw_t, raw_a = _bench_reshard(sizes, d, n_shards, reshard_to,
                                            0, dev)
    c_wire, c_t, c_a = _bench_reshard(sizes, d, n_shards, reshard_to,
                                      codec_level, dev)
    raw_total = raw_wire["wire_sent"] + raw_wire["wire_rcvd"]
    c_total = c_wire["wire_sent"] + c_wire["wire_rcvd"]
    same = all(np.array_equal(a, b) for a, b in
               list(zip(raw_t, c_t)) + list(zip(raw_a, c_a)))
    rows.append({
        "figure": "fig17", "kind": "compressed_reshard",
        "n_from": n_shards, "n_to": reshard_to, "codec_level": codec_level,
        "raw_wire_bytes": raw_total, "codec_wire_bytes": c_total,
        "codec_raw_bytes": c_wire["raw_sent"] + c_wire["raw_rcvd"],
        "wire_ratio": round(c_total / max(raw_total, 1), 4),
        "compressed_fewer_bytes": bool(c_total < raw_total),
        "image_matches_raw": bool(same),
    })

    # ---- shm name handoff vs streamed full ------------------------------
    shm = _bench_shm(sizes, d, n_shards, events, dev)
    s_ms, s_ok, s_wire, _ = shm["streamed"]
    h_ms, h_ok, h_wire, h_on = shm["shm"]
    rows.append({
        "figure": "fig17", "kind": "shm_full_handoff", "n_shards": n_shards,
        "streamed_ms": round(s_ms, 3), "shm_ms": round(h_ms, 3),
        "streamed_wire_bytes": s_wire["wire_sent"],
        "shm_wire_bytes": h_wire["wire_sent"],
        "shm_verified": bool(h_on),
        "shm_fewer_bytes": bool(h_wire["wire_sent"] < s_wire["wire_sent"]),
        "shm_not_slower": bool(h_ms <= s_ms * 1.5),
        "image_matches_sync": bool(s_ok and h_ok),
    })

    # ---- CUDA FNV-1a kernel vs the plain version on the host ------------
    host_ms, kern_ms, exact = _bench_hash(hash_rows, d, hash_trials, dev)
    rows.append({
        "figure": "fig17", "kind": "hash_kernel", "n_rows": hash_rows,
        "dim": d, "host_ms": round(host_ms, 3),
        "kernel_ms": round(kern_ms, 3),
        "speedup": round(host_ms / max(kern_ms, 1e-9), 2),
        "hash_kernel_exact": bool(exact),
    })
    return rows
