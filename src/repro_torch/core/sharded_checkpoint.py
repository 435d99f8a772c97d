"""Per-shard async checkpoint writer fleet with a coordinator fence.

The paper's production setting (and Check-N-Run, Eisenman et al.) decouples
snapshot from persist *per Emb-PS shard*: every shard owns its slice of each
embedding table and persists it independently, so a slow or failed shard
never blocks — or loses — the others' saves.  This module is the
coordinator of that architecture; the per-shard writers live behind a
**pluggable transport** (``repro_torch.core.transport``):

  * :class:`ShardedCheckpointWriter` owns one :class:`ShardEndpoint` per
    shard via a :class:`ShardTransport`.  ``backend="inproc"`` (alias
    ``"thread"``, the default — CI and laptops) runs each shard's
    ``_ShardStore`` under an in-process applier thread.  ``backend="pipe"``
    (alias ``"process"``) moves each apply loop into a spawned OS process:
    a writer crash — segfault, OOM-kill, operator SIGKILL — poisons one
    shard and never the trainer.  ``backend="socket"`` runs the same
    protocol over TCP so writers hosted by ``repro_torch.launch.shard_server``
    on *other hosts* join the fence.  The coordinator has ONE apply /
    fence / readmit code path; only the transport differs.

  * ``save_rows`` routes each row to its owning shard via
    ``EmbShardSpec.shard_of_rows``; ``save_full`` takes ONE immutable host
    snapshot shipped fleet-wide by the transport (inproc: shared arrays;
    pipe: a ``multiprocessing.shared_memory`` segment — zero disk writes
    on the critical path, with a spool-file fallback; socket: each shard
    streamed exactly its own slices) — either way the save-event critical
    path does not grow with shard count.

  * **Coordinator fence** (two-phase DRAIN/STAMP barrier): phase 1
    broadcasts DRAIN to every healthy shard and collects each shard's
    durable seq watermark — the worker batch-fsyncs its persisted event
    payloads before acking, so the watermark is power-loss-true.  Phase 2
    flushes the acked per-shard events into the coordinator manifest, in
    global ``seq`` order, and stamps a ``cycle`` record carrying the
    watermarks — only once every healthy shard has acked.  ``load_latest``
    only replays events logged *before* the last cycle stamp, so it
    reconstructs a consistent cross-shard image even when shards persisted
    at different rates.

  * **Per-shard fail-stop + re-admission**: a worker error, dead writer
    process, severed connection, or missed heartbeat poisons only its own
    shard.  Later work routed there is dropped (and counted), other shards
    keep saving; ``fence`` still drains and stamps the healthy shards
    before raising :class:`ShardSaveError`.  ``readmit`` reverses the
    poisoning at a cycle boundary: the writer is respawned (atomically —
    a failed respawn leaves the shard poisoned for retry at the next
    boundary), reseeded from its last-good image, and shipped a fresh full
    of the shard's current rows.  With ``readmit_backoff`` a crash-looping
    shard's re-admissions back off exponentially so it cannot thrash the
    fleet.  ``heartbeat_interval`` starts a monitor thread that probes the
    endpoints so a dead writer is discovered proactively, not at the next
    submit/fence.

  * **Run-versioned directories**: each run writes under its own
    ``run-<n>/`` (manifest + shard dirs + spool) and the root's atomic
    ``CURRENT`` pointer only advances at the run's *first stamped cycle* —
    a crash before the first fence can never corrupt the previous run's
    manifest.  Recovery chains through the manifests' ``parent`` links.

  * **Delta saves**: with ``delta_saves`` the writer keeps a 64-bit FNV-1a
    content hash per row of the last value it shipped; ``save_rows`` skips
    rows whose (value, accumulator) hash is unchanged.  Hashes are only
    advanced for rows actually accepted by a healthy shard.

Disk layout (all under the coordinator ``directory``)::

    CURRENT                           atomic pointer: newest stamped run
    run-<n>/manifest.json             that run's event log + cycle stamps
    run-<n>/shard_<j>/full_e<seq>.npz shard j's slice of every table at seq
    run-<n>/shard_<j>/partial_t<t>_e<seq>.npz
    run-<n>/shard_0/trainer_e<seq>.npz
    run-<n>/spool/spool_e<seq>.npz    pipe spool fallback (deleted at the
                                      next fence; shm mode writes nothing)

Every event carries the global, monotonically increasing ``seq`` assigned at
submit time; filenames are keyed by it, never by (table, step).  The
backend-parity tests assert byte-identical manifests (modulo timestamps)
and images across all three transports for identical schedules.

The port of ``repro.core.sharded_checkpoint``.  The coordinator's routing,
fence, restore, re-admission, resize, lease, attach and XOR-parity logic
is the reference's, over host numpy images; torch appears only at the
edges:

  * inputs may be torch tensors on any device (or numpy arrays); every
    host snapshot is a private copy (``host_copy``);
  * ``restore_shards`` writes the restored rows into the caller's tables
    and accumulators **in place** (as the port's flat store does) and
    returns the same lists;
  * the delta ledger is an int64 tensor (the uint64 bits of each row's
    hash) on the tables' device, hashed through ``kernels.ops.row_hash``:
    the ``row_hash`` CUDA kernel for device tables, its plain version for
    host ones, with the reference's bits either way.  ``save_full`` hashes
    the live tables where they lie; ``save_rows`` drops out-of-range
    rows, hashes and compares on the ledger's device and copies only the
    changed rows to the host.  Rows that live on the host (re-admission
    seeds, resize, takeover, parity reconstruction) are uploaded and
    hashed there too, so the ledger has one device.  The device picks
    where the hash runs: ``hash_backend`` accepts the reference's names
    (``"host"``, ``"pallas"``) and ``"kernel"`` so its configs carry
    over, and selects nothing.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core.checkpoint import (EmbShardSpec, _host, _leaves,
                                         _new_run_dir, _to_numpy,
                                         _write_current, atomic_json_dump,
                                         host_copy, load_trainer_tree,
                                         manifest_chain)
from repro_torch.core.transport import (DRAIN_TIMEOUT_S, TRANSPORT_ALIASES,
                                        TRANSPORTS, _ShardStore, fsync_path,
                                        make_transport, normalize_transport,
                                        xor_arrays, xor_into)

LAYOUT = "sharded-v1"

# The coordinator's durable control state, persisted atomically next to
# CURRENT: shard registry (writer addresses), monotonic epoch, last stamped
# cycle + per-shard watermarks, and the re-admission ledger.  A standby
# coordinator reads it to take over a live writer fleet
# (ShardedCheckpointWriter.attach); a superseded coordinator reads it to
# discover it must not stamp.
COORDINATOR_PTR = "COORDINATOR"

# The coordinator lease (opt-in leader election, ``lease_ttl=``): a small
# record renewed by the active coordinator at every stamp and heartbeat
# sweep.  A standby checks it BEFORE claiming an epoch — a losing standby
# discovers it lost for the price of one file read instead of a full
# attach() takeover.
LEASE_PTR = "LEASE"

# accepted ``backend=`` names (transports + their legacy aliases)
BACKENDS = TRANSPORTS + tuple(TRANSPORT_ALIASES)
# accepted ``hash_backend=`` names (the reference's and "kernel"); the
# tables' device picks where the hash runs
HASH_BACKENDS = ("host", "kernel", "pallas")

# numpy loader indirection: the crash/reconcile tests monkeypatch this to
# emulate a shard directory the coordinator cannot read (remote-only
# storage), which drives the rebuild-over-transport reconcile path
_load_npz = np.load

class ShardSaveError(RuntimeError):
    """One or more shard writers failed (fail-stop).  Healthy shards' saves
    were drained and stamped before this was raised."""

    def __init__(self, shard_errors: Dict[int, BaseException]):
        self.shard_errors = dict(shard_errors)
        names = ", ".join(f"{j}: {e!r}" for j, e in
                          sorted(self.shard_errors.items()))
        super().__init__(
            f"checkpoint writer(s) for shard(s) "
            f"{sorted(self.shard_errors)} failed fail-stop ({names}); "
            f"their saves after the failure were discarded, other shards' "
            f"saves are intact")


class StaleCoordinatorError(RuntimeError):
    """This coordinator's epoch has been superseded (a standby took over
    the fleet): it must not stamp — its fence refuses before touching the
    manifest or CURRENT, so the successor's stamps can never be clobbered
    by a hung-then-resumed predecessor."""


class LeaseHeldError(RuntimeError):
    """The directory's coordinator lease is live: the active coordinator
    renewed it within its TTL.  A standby that races a healthy leader
    fails HERE — before claiming an epoch or touching the fleet — instead
    of discovering the loss after a full takeover."""


# Default cross-host clock-skew slack for lease reads, in seconds.  The
# LEASE record's ``expires`` is a *wall-clock* timestamp written by the
# leader and compared against the reader's own wall clock — the only
# cross-host wall-clock comparison in the system.  The contract: every
# host that may read or write the lease keeps its clock NTP-synced to
# within this slack.  A standby whose clock runs AHEAD of the leader's
# would otherwise see a live lease as expired and split-brain; erring on
# the side of "still held" costs only takeover latency, never safety.
LEASE_CLOCK_SKEW_S = 2.0


def lease_status(root_dir: str,
                 skew_slack: float = LEASE_CLOCK_SKEW_S) -> Optional[dict]:
    """The ``LEASE`` record with a computed ``held`` flag, or None when
    the directory has no (readable) lease — lease election is opt-in via
    ``lease_ttl=``.

    ``held`` treats the lease as live until ``expires + skew_slack``
    (local wall clock): cross-host clock skew up to ``skew_slack`` can
    never make a standby steal a lease its leader still holds.  The
    symmetric error — a dead leader's lease lingering ``skew_slack``
    longer — only delays takeover, which is the safe direction."""
    path = os.path.join(root_dir, LEASE_PTR)
    try:
        with open(path) as f:
            rec = json.load(f)
    except (OSError, ValueError):
        return None
    # lint: allow[time-source] the lease contract is explicitly wall-clock
    # (cross-host comparison against the leader's persisted ``expires``);
    # monotonic time has no cross-host meaning here
    rec["held"] = float(rec.get("expires", 0)) + float(skew_slack) > time.time()
    return rec


def _read_coordinator_state(root_dir: str) -> Optional[dict]:
    """The durable ``COORDINATOR`` record, or None when the directory has
    never hosted a coordinator (or predates the failover layout)."""
    path = os.path.join(root_dir, COORDINATOR_PTR)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _newest_claim_epoch(root_dir: str) -> int:
    """The highest ``.epoch-<n>.claim`` marker in ``root_dir`` (0 when
    none).  Markers are created with O_EXCL at the very first instant of a
    claim — before any takeover work — so, unlike the COORDINATOR record
    (written only once the fleet is up), they are a race-free signal that
    a successor exists."""
    newest = 0
    try:
        names = os.listdir(root_dir)
    except OSError:
        return newest
    for d in names:
        if d.startswith(".epoch-") and d.endswith(".claim"):
            try:
                newest = max(newest, int(d[len(".epoch-"):-len(".claim")]))
            except ValueError:
                continue
    return newest


def _last_stamp(chain) -> Tuple[int, Dict[int, int]]:
    """(cycle, per-shard durable watermark) of the newest stamped cycle
    across a manifest chain — the consistency point a takeover must land
    on; ``(0, {})`` when nothing was ever stamped."""
    cycle, wm = 0, {}
    for _, m in chain:
        for e in m["events"]:
            if e["kind"] == "cycle":
                cycle = e["cycle"]
                wm = {int(k): int(v)
                      for k, v in e.get("shard_seq", {}).items()}
    return cycle, wm


def _write_slice(dst, lo: int, hi: int, src: np.ndarray) -> None:
    """``dst[lo:hi] = src`` in place, for a tensor (any device) or an
    array."""
    if isinstance(dst, torch.Tensor):
        src = np.asarray(src)
        if not src.flags.writeable:
            src = np.array(src)
        dst[lo:hi].copy_(torch.from_numpy(np.ascontiguousarray(src)))
    else:
        dst[lo:hi] = src


def _row_nbytes(a) -> int:
    """Bytes of one row of ``a`` (a numpy array or tensor of n > 0 rows)."""
    total = (a.numel() * a.element_size() if isinstance(a, torch.Tensor)
             else a.nbytes)
    return total // a.shape[0]


def _stamped_events(chain) -> List[Tuple[str, dict]]:
    """Merged ``(run_dir, event)`` list across a manifest chain, each run
    cut at its *last* cycle stamp — events a fence never stamped are not
    recovery-eligible, whichever run logged them."""
    out: List[Tuple[str, dict]] = []
    for run_dir, m in chain:
        evs = m["events"]
        last = None
        for i, e in enumerate(evs):
            if e["kind"] == "cycle":
                last = i
        for e in (evs[:last] if last is not None else []):
            out.append((run_dir, e))
    return out


def _replay_shard(store: _ShardStore, j: int,
                  events: Sequence[Tuple[str, dict]]):
    """Replay shard ``j``'s stamped events into ``store``'s image slices,
    strictly in manifest order from its last full event onward."""
    evs = [(d, e) for d, e in events
           if e.get("shard") == j and e["kind"] in ("full", "partial")]
    full_idx = None
    for i, (_, e) in enumerate(evs):
        if e["kind"] == "full":
            full_idx = i
    start = 0
    if full_idx is not None:
        run_dir, e = evs[full_idx]
        path = os.path.join(run_dir, f"shard_{j}", f"full_e{e['seq']}.npz")
        with _load_npz(path) as z:
            for t in range(len(store.image_tables)):
                store.image_tables[t][...] = z[f"table_{t}"]
                store.image_accs[t][...] = z[f"acc_{t}"]
        start = full_idx + 1
    for run_dir, e in evs[start:]:
        if e["kind"] != "partial":
            continue
        with _load_npz(os.path.join(run_dir, f"shard_{j}", e["file"])) as z:
            t = int(z["table"])
            local = z["rows"] - store.ranges[t][0]
            store.image_tables[t][local] = z["values"]
            store.image_accs[t][local] = z["accs"]


# ======================================================================
# layout epochs (elastic resharding)
# ======================================================================
def _spec_from_record(table_sizes, rec: dict) -> EmbShardSpec:
    """Materialize a layout-epoch record (manifest ``layout_epoch`` field
    or a stamped ``layout`` event) into a spec."""
    return EmbShardSpec(table_sizes, int(rec["n_shards"]),
                        boundaries=rec.get("boundaries"))


def _stamped_layout_events(chain) -> List[Tuple[str, dict, EmbShardSpec]]:
    """Like :func:`_stamped_events`, but layout-epoch aware: a merged
    ``(run_dir, event, spec)`` list where ``spec`` is the layout epoch
    that was *active when the event was logged* — the boundaries its
    shard ids must be re-sliced through.

    Each run contributes its events up to its last ``cycle`` stamp.  A
    run's starting layout comes from its ``layout_epoch`` manifest record
    (legacy manifests fall back to the formula layout for the top-level
    ``n_shards``); stamped ``layout`` events switch the active spec
    mid-run.  ``layout`` events themselves are included (plan builders
    need them); image replay skips them."""
    spec: Optional[EmbShardSpec] = None
    out: List[Tuple[str, dict, EmbShardSpec]] = []
    for run_dir, m in chain:
        sizes = tuple(m["table_sizes"])
        rec = m.get("layout_epoch")
        if rec is not None:
            spec = _spec_from_record(sizes, rec)
        elif spec is None or tuple(spec.table_sizes) != sizes:
            spec = EmbShardSpec(sizes, int(m["n_shards"]))
        evs = m["events"]
        last = None
        for i, e in enumerate(evs):
            if e["kind"] == "cycle":
                last = i
        for e in (evs[:last] if last is not None else []):
            if e["kind"] == "layout":
                spec = _spec_from_record(sizes, e)
            out.append((run_dir, e, spec))
    return out


def _final_layout(chain) -> Tuple[Optional[EmbShardSpec], int]:
    """``(spec, layout_epoch)`` of the newest stamped layout across a
    manifest chain — the layout the final stamp was taken under, which a
    restarting coordinator (or ``load_latest`` caller) must match.
    ``layout`` events only ever reach disk inside the same atomic
    manifest write as their cycle stamp, so every one on disk counts."""
    spec: Optional[EmbShardSpec] = None
    epoch = 1
    for _, m in chain:
        sizes = tuple(m["table_sizes"])
        rec = m.get("layout_epoch")
        if rec is not None:
            spec = _spec_from_record(sizes, rec)
            epoch = max(epoch, int(rec.get("epoch", 1)))
        elif spec is None:
            spec = EmbShardSpec(sizes, int(m["n_shards"]))
        for e in m["events"]:
            if e["kind"] == "layout":
                spec = _spec_from_record(sizes, e)
                epoch = max(epoch, int(e.get("layout_epoch", epoch)))
    return spec, epoch


def _replay_global(chain, tables, accs, trainer_template=None,
                   tolerant: bool = False):
    """Cross-epoch replay of every stamped event into the *global*
    ``tables`` / ``accs`` arrays (mutated in place), re-slicing each
    event's rows through the layout epoch that was active when it was
    logged.

    Applied in reverse with per-row fill masks, so each row lands on its
    newest stamped write exactly once — byte-identical to the legacy
    per-shard "last full, then later partials" replay for a single-layout
    chain, but correct across splits/merges (a ``full`` of shard ``j``
    occupies whatever global offsets shard ``j`` owned *under its own
    epoch's boundaries*), and it never re-reads history a newer full
    already buried.

    Returns ``(trainer_image, taint, trainer_bad)``.  ``trainer_image``
    is None when no stamped trainer event exists.  With ``tolerant``, a
    file that cannot be read does not raise: the rows whose newest write
    it held are *tainted* (per-table boolean masks) so the caller knows
    exactly which current-layout shards are unrecoverable coordinator-
    side; otherwise ``taint`` is None and read errors propagate."""
    stream = _stamped_layout_events(chain)
    taint = ([np.zeros(len(t), bool) for t in tables] if tolerant else None)
    filled = [np.zeros(len(t), bool) for t in tables]
    trainer = None
    trainer_bad = False
    trainer_done = False
    for run_dir, e, spec in reversed(stream):
        kind = e["kind"]
        if kind == "full":
            j = e["shard"]
            need = [t for t in range(len(tables))
                    if not filled[t][slice(*spec.shard_range(t, j))].all()]
            if not need:
                continue
            path = os.path.join(run_dir, f"shard_{j}",
                                f"full_e{e['seq']}.npz")
            try:
                with _load_npz(path) as z:
                    for t in need:
                        lo, hi = spec.shard_range(t, j)
                        m = ~filled[t][lo:hi]
                        tables[t][lo:hi][m] = z[f"table_{t}"][m]
                        accs[t][lo:hi][m] = z[f"acc_{t}"][m]
                        filled[t][lo:hi] = True
            except Exception:
                if not tolerant:
                    raise
                for t in need:
                    lo, hi = spec.shard_range(t, j)
                    taint[t][lo:hi][~filled[t][lo:hi]] = True
                    filled[t][lo:hi] = True
        elif kind == "partial":
            j = e["shard"]
            try:
                with _load_npz(os.path.join(run_dir, f"shard_{j}",
                                            e["file"])) as z:
                    t = int(z["table"])
                    rows = np.asarray(z["rows"])
                    m = ~filled[t][rows]
                    tables[t][rows[m]] = np.asarray(z["values"])[m]
                    accs[t][rows[m]] = np.asarray(z["accs"])[m]
                    filled[t][rows[m]] = True
            except Exception:
                if not tolerant:
                    raise
                # the partial's exact rows are unknowable without the
                # file: conservatively taint the shard's whole epoch range
                for t in range(len(tables)):
                    lo, hi = spec.shard_range(t, j)
                    taint[t][lo:hi][~filled[t][lo:hi]] = True
                    filled[t][lo:hi] = True
        elif kind == "trainer" and not trainer_done:
            trainer_done = True
            try:
                trainer = load_trainer_tree(
                    os.path.join(run_dir, "shard_0", e["file"]),
                    trainer_template)
            except Exception:
                if not tolerant:
                    raise
                trainer_bad = True
    return trainer, taint, trainer_bad


def _layout_plan(chain) -> list:
    """The stamped history as a worker-shippable replay script — the
    payload of the ``rebuild`` frame (remote-disk reconcile).  Ops match
    ``transport.replay_plan_into_store``: ``("layout", n, boundaries)``
    switches the epoch the following shard ids resolve through;
    ``("full"/"partial", shard, path)`` and ``("trainer", path)`` carry
    *server-local* absolute paths (the same contract the ``spawn``
    directory has) — the receiving session replays only its own rows."""
    plan: list = []
    cur: Optional[EmbShardSpec] = None
    for run_dir, e, spec in _stamped_layout_events(chain):
        if spec is not cur:
            plan.append(("layout", spec.n_shards,
                         [b.tolist() for b in spec.boundaries]))
            cur = spec
        if e["kind"] == "full":
            plan.append(("full", int(e["shard"]), os.path.join(
                run_dir, f"shard_{e['shard']}", f"full_e{e['seq']}.npz")))
        elif e["kind"] == "partial":
            plan.append(("partial", int(e["shard"]), os.path.join(
                run_dir, f"shard_{e['shard']}", e["file"])))
        elif e["kind"] == "trainer":
            plan.append(("trainer", os.path.join(
                run_dir, "shard_0", e["file"])))
    return plan


class ShardedCheckpointWriter:
    """One checkpoint writer + directory per Emb-PS shard, one coordinator.

    Drop-in for the (store, writer) pair ``CPRManager`` keeps: exposes
    ``save_full`` / ``save_rows`` / ``fence`` / ``close`` plus the store-side
    surface (``restore_shards``, ``restore_all``, ``bytes_written``,
    ``save_events``, assembled ``image_tables`` / ``image_accs`` views).

    The writer fleet sits behind a transport (``backend=`` one of
    ``inproc`` / ``pipe`` / ``socket``, legacy aliases ``thread`` /
    ``process``); the coordinator's routing, fence, restore and
    re-admission logic is transport-agnostic.  The crash-injection suite
    SIGKILLs pipe workers and socket servers mid-save and recovery must
    still land exactly on the last stamped cycle.
    """

    def __init__(self, tables, accs, spec: EmbShardSpec, trainer_state=None,
                 directory: Optional[str] = None, async_save: bool = True,
                 delta_saves: bool = True, max_inflight: int = 2,
                 backend: str = "thread",
                 drain_timeout: Optional[float] = None,
                 snapshot: Optional[str] = None,
                 addresses: Optional[Sequence] = None,
                 fsync_payloads: bool = True,
                 heartbeat_interval: Optional[float] = None,
                 readmit_backoff: float = 0.0,
                 readmit_backoff_max: float = 60.0,
                 lease_ttl: Optional[float] = None,
                 transport_options: Optional[dict] = None,
                 parity_group_size: int = 0,
                 parity_hot_shards: Sequence[int] = (),
                 hash_backend: str = "host",
                 _takeover: Optional[dict] = None):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        if hash_backend not in HASH_BACKENDS:
            raise ValueError(f"unknown hash_backend {hash_backend!r}")
        # the ledger lives on the tables' device (the CPU for host inputs,
        # where ops.row_hash runs the plain version)
        first = tables[0] if len(tables) else None
        self._ledger_device = (first.device if isinstance(first, torch.Tensor)
                               else torch.device("cpu"))
        self.hash_backend = ("kernel" if self._ledger_device.type == "cuda"
                             else "host")
        self.spec = spec
        self.n_shards = spec.n_shards
        self.backend = normalize_transport(backend)
        # remote transports are inherently asynchronous (saves return
        # after the submit hand-off; durability comes from fence()) —
        # normalize the flag so callers and report() see the true semantics
        self.async_save = True if self.backend != "inproc" else async_save
        self.delta_saves = delta_saves
        self.fsync_payloads = fsync_payloads
        host_t = [_host(t) for t in tables]
        host_a = [_host(a) for a in accs]
        self.ranges = [[spec.shard_range(t, j)
                        for t in range(len(spec.table_sizes))]
                       for j in range(self.n_shards)]
        # poisoned shards: owned by the trainer thread (every mutation and
        # iteration happens there; the heartbeat thread only latches
        # endpoints and does point lookups)
        self.failed: Dict[int, BaseException] = {}
        self.shard_readmissions = 0
        self._closed = False
        self._closing = False           # close() has begun: monitor stands
        #                                 down even if its join timed out
        # serializes the heartbeat monitor's probe sweeps against the
        # fence's DRAIN window and against close() — a sweep can never
        # latch a shard "dead" from the silence of its own mid-drain or
        # mid-shutdown quiescence (the heartbeat/close race)
        self._monitor_lock = threading.Lock()
        self._seq = 0                   # guarded by: _seq_lock
        self._seq_lock = threading.Lock()
        self.cycle = 0
        self._drain_token = 0           # guarded by: _monitor_lock
        self._drain_timeout = drain_timeout or DRAIN_TIMEOUT_S
        self.dropped_bytes = 0          # routed to a poisoned shard
        self.delta_rows_skipped = 0
        self.delta_bytes_skipped = 0
        self._hashes = (self._hash_tables(tables, accs) if delta_saves
                        else None)
        self._watermarks = [0] * self.n_shards   # durable seq per shard
        self.layout_epoch = 1           # bumped by every stamped resize
        self.lease_ttl = lease_ttl
        self.reshard_history: List[dict] = []
        # coordinator-born events (layout stamps) waiting for the next
        # fence: merged into the drained worker events and committed in
        # the SAME atomic manifest write as their cycle record
        self._pending_manifest_events: List[dict] = []
        # worker events drained by quiesce() (a drain without a stamp):
        # collect_applied pops the workers' ack lists, so these MUST be
        # merged into the next fence's manifest write or the acked saves
        # would silently vanish from the stamped history
        self._pending_drained: List[dict] = []

        # ---- readmission back-off (crash-loop throttle) ----
        self.readmit_backoff = readmit_backoff        # base secs; 0 = off
        self.readmit_backoff_max = readmit_backoff_max
        self._readmit_attempts = [0] * self.n_shards
        self._readmit_not_before = [0.0] * self.n_shards
        self._last_readmit_t = [0.0] * self.n_shards

        # ---- run-versioned directory layout + coordinator epoch claim ----
        self.root_dir = directory
        self.run_dir: Optional[str] = None
        self._current_advanced = False
        self.epoch = 1                  # monotonic coordinator ownership
        chain = []
        if directory:
            # claim the fleet: every restart (plain or takeover) is a new
            # epoch, so a predecessor that un-hangs finds itself superseded
            # at its next frame / stamp attempt.  The claim itself is an
            # O_EXCL marker file, so two simultaneous claimants get
            # DISTINCT epochs (the lower one fails the ownership check at
            # its first stamp) instead of racing read-inc-write to the
            # same number.
            os.makedirs(directory, exist_ok=True)
            prior = _read_coordinator_state(directory)
            self.epoch = (int(prior.get("epoch", 0)) + 1
                          if prior is not None else 1)
            self.epoch = max(self.epoch, _newest_claim_epoch(directory) + 1)
            while True:
                try:
                    fd = os.open(
                        os.path.join(directory,
                                     f".epoch-{self.epoch}.claim"),
                        os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                    os.close(fd)
                    break
                except FileExistsError:
                    self.epoch += 1
            # bounded accumulation: markers far below the claimed epoch
            # are dead (claimants always probe upward from the newest)
            for d in os.listdir(directory):
                if d.startswith(".epoch-") and d.endswith(".claim"):
                    try:
                        n = int(d[len(".epoch-"):-len(".claim")])
                    except ValueError:
                        continue
                    if n < self.epoch - 4:
                        try:
                            os.unlink(os.path.join(directory, d))
                        except OSError:
                            pass
            # layout validation is cross-epoch aware: runs in the chain
            # may carry OLDER layouts (pre-resize); only the FINAL stamped
            # layout must match the caller's spec
            chain = manifest_chain(directory, LAYOUT, None)
            if chain:
                for _, m in chain:
                    if list(m.get("table_sizes", ())) != \
                            list(spec.table_sizes):
                        raise ValueError(
                            f"manifest in {directory} is for table_sizes="
                            f"{m.get('table_sizes')} but the caller's "
                            f"spec has table_sizes="
                            f"{list(spec.table_sizes)}")
                final_spec, self.layout_epoch = _final_layout(chain)
                if final_spec is not None and \
                        not spec.same_layout(final_spec):
                    raise ValueError(
                        f"checkpoint directory {directory} last stamped "
                        f"a layout with n_shards={final_spec.n_shards} "
                        f"but the caller's spec has n_shards="
                        f"{spec.n_shards}: pass the stamped layout "
                        f"(load_latest_auto / attach adopt it) or "
                        f"resize() after construction")
            self._seq = max((e.get("seq", 0) for _, m in chain
                             for e in m["events"]), default=0)
            self.cycle = max((e["cycle"] for _, m in chain
                              for e in m["events"]
                              if e["kind"] == "cycle"), default=0)
            self.run_dir, run_name, parent = _new_run_dir(directory)
            self._manifest = {"layout": LAYOUT, "run": run_name,
                              "parent": parent,
                              "n_shards": self.n_shards,
                              "table_sizes": list(spec.table_sizes),
                              "layout_epoch": {
                                  "epoch": self.layout_epoch,
                                  "n_shards": self.n_shards,
                                  "boundaries": [b.tolist()
                                                 for b in spec.boundaries],
                                  "parent": (self.layout_epoch - 1
                                             if self.layout_epoch > 1
                                             else None)},
                              "events": []}
        self.directory = self.run_dir   # this run's files live here

        # ---- per-shard seed slices ----
        # pristine initial slices per shard: the disk-replay base (a row
        # never covered by a stamped event restores to its initial value)
        # and every transport's spawn seed.  Never mutated.
        trainer_np = _to_numpy(trainer_state)
        self._init_slices = [
            ([np.array(host_t[t][lo:hi])
              for t, (lo, hi) in enumerate(self.ranges[j])],
             [np.array(host_a[t][lo:hi])
              for t, (lo, hi) in enumerate(self.ranges[j])],
             trainer_np if j == 0 else None)
            for j in range(self.n_shards)]
        # last-known image per shard: the restore fallback when a remote
        # worker is dead and there is no disk to replay; starts as the
        # (shared, read-only) init slices, replaced wholesale by every
        # successful fetch
        self._img_cache = list(self._init_slices)

        # ---- takeover reconciliation (standby coordinator) ----
        # ONE tolerant cross-epoch replay of the stamped history (layout
        # changes re-sliced through their own epochs' boundaries), then
        # per-shard seeds cut under the CURRENT layout: they seed the
        # transport (an adopted writer whose durable watermark differs
        # from the stamp is reseeded with them — the gap of applied-but-
        # unstamped work is discarded; a fresh spawn starts from them
        # directly), re-base the delta hashes, and become the restore
        # cache.  A shard whose stamped rows the coordinator cannot read
        # (remote-only storage) is poisoned — except on the socket
        # transport, where the stamped-event plan is shipped to the
        # writer so it rebuilds from its OWN local files instead.
        seeds = self._init_slices
        self._pending_poison: Dict[int, BaseException] = {}
        self._pending_rebuild: Dict[int, list] = {}
        self.attach_report: Optional[dict] = None
        if _takeover is not None:
            _, stamped_wm = _last_stamp(chain)
            self._watermarks = [stamped_wm.get(j, 0)
                                for j in range(self.n_shards)]
            g_t, g_a = self._assemble(self._init_slices)
            g_tr, taint, tr_bad = _replay_global(
                chain, g_t, g_a, trainer_template=trainer_np,
                tolerant=True)
            if g_tr is None:
                g_tr = trainer_np
            seeds, seed_ok = [], []
            plan = None
            for j in range(self.n_shards):
                bad = any(taint[t][lo:hi].any()
                          for t, (lo, hi) in enumerate(self.ranges[j]))
                bad = bad or (j == 0 and tr_bad)
                seeds.append((
                    [np.array(g_t[t][lo:hi])
                     for t, (lo, hi) in enumerate(self.ranges[j])],
                    [np.array(g_a[t][lo:hi])
                     for t, (lo, hi) in enumerate(self.ranges[j])],
                    g_tr if j == 0 else None))
                seed_ok.append(not bad)
                if not bad:
                    continue
                if self.backend == "socket":
                    if plan is None:
                        plan = _layout_plan(chain)
                    self._pending_rebuild[j] = plan
                else:
                    self._pending_poison[j] = RuntimeError(
                        f"shard {j}: stamped image replay failed at "
                        f"takeover: unreadable stamped file(s) cover "
                        f"its rows")
            self._img_cache = list(seeds)   # seeds already fall back to
            #                                 init slices where replay failed
            if self._hashes is not None:
                for j in range(self.n_shards):
                    for t, (lo, hi) in enumerate(self.ranges[j]):
                        self._hashes[t][lo:hi] = self._hash(seeds[j][0][t],
                                                            seeds[j][1][t])

        # ---- the transport + its endpoints ----
        shard_dirs = [os.path.join(self.run_dir, f"shard_{j}")
                      if self.run_dir else None
                      for j in range(self.n_shards)]
        opts = dict(transport_options or {})
        opts.setdefault("fsync_payloads", fsync_payloads)
        opts.setdefault("epoch", self.epoch)
        if self.backend == "inproc":
            opts.setdefault("async_save", self.async_save)
            opts.setdefault("max_inflight", max_inflight)
        elif self.backend == "pipe":
            if snapshot is not None:
                opts.setdefault("snapshot", snapshot)
            if self.run_dir:            # else the transport mkdtemps its
                opts.setdefault("spool_dir",      # own dir and removes it
                                os.path.join(self.run_dir, "spool"))
        else:
            if addresses is not None:
                opts.setdefault("addresses", list(addresses))
            if _takeover is not None:
                # adopt still-running shard_server writers over a fresh
                # connection instead of respawning the world; pipe/inproc
                # writers died with the old coordinator process and are
                # simply respawned from the stamped seeds above
                opts.setdefault("attach_watermarks", list(self._watermarks))
                opts.setdefault("attach_seed_ok", seed_ok)
                if self._pending_rebuild:
                    opts.setdefault(
                        "attach_rebuild_plans",
                        [self._pending_rebuild.get(j)
                         for j in range(self.n_shards)])
                if _takeover.get("fallback") is not None:
                    opts.setdefault("attach_fallback_spawn",
                                    _takeover["fallback"])
        self.transport = make_transport(self.backend, spec, seeds,
                                        shard_dirs, **opts)
        self.endpoints = self.transport.endpoints
        for j, err in self._pending_poison.items():
            self.endpoints[j].poison(err)
            self.failed[j] = self.endpoints[j].error
        for j, ep in enumerate(self.endpoints):
            if j not in self.failed and ep.error is not None:
                self.failed[j] = ep.error          # failed adoption
        for j in sorted(self._pending_rebuild):
            # a shard kept or rebuilt from its own local files holds state
            # the coordinator never saw: pull its image back to refresh
            # the restore cache and re-base the delta hashes (the seed we
            # computed for it was tainted by the unreadable files)
            if j in self.failed:
                continue
            got = self.endpoints[j].fetch_image(self._drain_timeout)
            if got is None:
                self.failed[j] = self.endpoints[j].error
                continue
            self._img_cache[j] = got
            if self._hashes is not None:
                for t, (lo, hi) in enumerate(self.ranges[j]):
                    self._hashes[t][lo:hi] = self._hash(got[0][t], got[1][t])
        if _takeover is not None:
            self.shard_readmissions = int(
                _takeover.get("state", {}).get("readmissions", 0))
            self.attach_report = {
                "epoch": self.epoch,
                "adopted": [j for j, ep in enumerate(self.endpoints)
                            if ep.adopted],
                "respawned": [j for j, ep in enumerate(self.endpoints)
                              if not ep.adopted and j not in self.failed],
                "poisoned": sorted(self.failed),
                "reconciled": {j: ep.reconciled
                               for j, ep in enumerate(self.endpoints)
                               if ep.reconciled is not None},
                "cycle": self.cycle,
            }
        if self.root_dir:
            # claim (or re-stamp) the durable coordinator record now that
            # the fleet is up and socket addresses are known
            self._persist_coordinator_state()
            self._renew_lease()

        # ---- XOR parity redundancy (ECRM-style reconstruction) ----
        self._init_parity(parity_group_size, parity_hot_shards)

        # ---- heartbeat monitor (proactive dead-writer detection) ----
        self.heartbeat_interval = heartbeat_interval
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        if heartbeat_interval:
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop, name="cpr-fleet-heartbeat",
                daemon=True)
            self._hb_thread.start()

    # ------------------------------------------------------ hash ledger --
    def _on_ledger(self, a) -> torch.Tensor:
        """``a`` as a tensor on the ledger's device (no copy when it
        already lies there)."""
        if isinstance(a, torch.Tensor):
            return a.detach().to(self._ledger_device).contiguous()
        a = np.asarray(a)
        if not a.flags.writeable:   # deserialized frames are read-only
            a = np.array(a)
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            self._ledger_device)

    def _hash(self, values, acc_values) -> torch.Tensor:
        """Per-row hashes as an int64 tensor on the ledger's device."""
        from repro_torch.kernels import ops
        return ops.row_hash(self._on_ledger(values),
                            self._on_ledger(acc_values))

    def _hash_tables(self, tables, accs) -> List[torch.Tensor]:
        """Hashes of whole tables, read where the live tables lie."""
        return [self._hash(t, a) for t, a in zip(tables, accs)]

    # --------------------------------------------- legacy backend surface --
    @property
    def stores(self) -> Optional[List[_ShardStore]]:
        """Inproc transport: the per-shard stores (tests poke them)."""
        if self.transport.is_remote:
            return None
        return [ep.store for ep in self.endpoints]

    @property
    def appliers(self):
        """Inproc transport: the per-shard applier threads."""
        if self.transport.is_remote:
            return None
        return [ep.applier for ep in self.endpoints]

    @property
    def procs(self):
        """Remote transports: the per-shard endpoints (``.pid`` is the
        writer/server process for crash drills)."""
        return self.endpoints if self.transport.is_remote else None

    # --------------------------------------------------------- accounting --
    @property
    def bytes_written(self) -> int:
        return sum(self.shard_bytes)

    @property
    def save_events(self) -> int:
        return sum(self.shard_events)

    @property
    def shard_bytes(self) -> List[int]:
        return [ep.bytes_written for ep in self.endpoints]

    @property
    def shard_events(self) -> List[int]:
        return [ep.save_events for ep in self.endpoints]

    @property
    def wire_stats(self):
        """Raw-vs-wire byte counters from the transport (socket backend
        with codec/mux), or None where the wire concept does not apply."""
        fn = getattr(self.transport, "wire_stats", None)
        return fn() if callable(fn) else None

    @property
    def image_tables(self) -> List[np.ndarray]:
        """Assembled full-table image (copy).  Fence before reading."""
        return self._assemble()[0]

    @property
    def image_accs(self) -> List[np.ndarray]:
        return self._assemble()[1]

    @property
    def trainer_image(self):
        return self._shard_images(0)[2]

    # ------------------------------------------------------- image access --
    def _shard_images(self, j: int):
        """(table_slices, acc_slices, trainer_image) for shard ``j``'s
        current image.  Healthy endpoint: fetched live.  Dead/poisoned
        remote endpoint: the last-good image is replayed from the stamped
        events on disk, falling back to the last fetched image.  The inproc
        stores live in this process, so their image survives poisoning
        (frozen at the last successful apply)."""
        ep = self.endpoints[j]
        if (j not in self.failed and ep.error is None) or \
                ep.image_survives_failure:
            got = ep.fetch_image(self._drain_timeout)
            if got is not None:
                if not ep.image_survives_failure:
                    self._img_cache[j] = got
                return got
            self.failed[j] = ep.error
        # parity reconstruction beats stamped-replay: the peers' data +
        # parity give the shard's CURRENT image (zero rollback); any
        # unmet precondition falls through to the stamped chain
        rec = self.reconstruct_shard(j)
        if rec is not None:
            self._img_cache[j] = rec
            return rec
        if self.root_dir is not None:
            disk = self._replay_shard_from_disk(j)
            if disk is not None:
                return disk
        return self._img_cache[j]

    def _replay_shard_from_disk(self, j: int):
        """Shard ``j``'s last-good image per the stamped on-disk history,
        replayed over the PRISTINE init image — the live-image cache may
        hold post-stamp state (a fetch after unstamped applies), and a
        poisoned shard's restore must land exactly on the last stamped
        image.  The replay is cross-epoch (the chain may span resharding:
        shard ``j``'s current rows can be covered by events other shard
        ids logged under older layouts).  Events only reach a manifest
        together with their cycle stamp (one atomic write per fence), and
        the first stamp advances CURRENT to this run — so the
        CURRENT-rooted chain always covers everything this writer has
        stamped.  None when nothing stamped covers the shard yet."""
        chain = manifest_chain(self.root_dir, LAYOUT, None)
        covered = False
        for _, e, spec in _stamped_layout_events(chain):
            if e["kind"] not in ("full", "partial"):
                continue
            for t, (lo, hi) in enumerate(self.ranges[j]):
                elo, ehi = spec.shard_range(t, e["shard"])
                if max(lo, elo) < min(hi, ehi):
                    covered = True
                    break
            if covered:
                break
        if not covered:
            return None
        g_t, g_a = self._assemble(self._init_slices)
        # the shard-0 init trainer image is the structure template
        # (without one the raw leaf list would come back)
        trainer, _, _ = _replay_global(
            chain, g_t, g_a, trainer_template=self._init_slices[0][2])
        if trainer is None:
            trainer = self._init_slices[0][2]
        return ([np.array(g_t[t][lo:hi])
                 for t, (lo, hi) in enumerate(self.ranges[j])],
                [np.array(g_a[t][lo:hi])
                 for t, (lo, hi) in enumerate(self.ranges[j])],
                trainer if j == 0 else None)

    def _assemble(self, images=None):
        """Assemble full tables from per-shard image slices.  ``images``
        lets a caller that also needs the trainer replica pay for one
        per-shard fetch instead of several (remote transports: each fetch
        ships the shard's whole image over the wire)."""
        tabs, accs = [], []
        if images is None:
            images = [self._shard_images(j) for j in range(self.n_shards)]
        for t, n in enumerate(self.spec.table_sizes):
            tab = np.empty((n,) + images[0][0][t].shape[1:],
                           images[0][0][t].dtype)
            acc = np.empty((n,) + images[0][1][t].shape[1:],
                           images[0][1][t].dtype)
            for j in range(self.n_shards):
                lo, hi = self.ranges[j][t]
                tab[lo:hi] = images[j][0][t]
                acc[lo:hi] = images[j][1][t]
            tabs.append(tab)
            accs.append(acc)
        return tabs, accs

    # ---------------------------------------------- XOR parity (ECRM) ------
    # The redundancy layer behind the ``reconstruct`` readmit path: shards
    # are partitioned into parity groups; each group's XOR stripe (per
    # table, stripe row i = bytewise XOR of every member's local row i)
    # lives on the group's HOLDER writer — the first shard of the next
    # group, i.e. outside the group whenever there are >= 2 groups — as
    # soft in-memory state shipped over ``parity`` frames.  The
    # coordinator keeps a host-side MIRROR of every shard's last-accepted
    # image so row saves can be turned into XOR deltas (old ^ new) without
    # a writer round-trip; recovery itself deliberately reads ONLY the
    # surviving peers' data + parity (never the mirror), so the exercised
    # path matches a deployment where the delta is computed trainer-side.
    # A group whose holder missed an update is STALE: reconstruction is
    # refused (stamped-replay fallback) until the stripe is reseeded from
    # the mirror at the next readmit / save_full / configure_parity.

    def _init_parity(self, group_size: int, hot_shards: Sequence[int] = ()):
        self.parity_group_size = int(group_size or 0)
        self.parity_enabled = (self.parity_group_size > 0 and
                               self.n_shards >= 2)
        self.parity_reconstructions = 0
        self.parity_fallbacks = 0
        self._parity_groups: List[List[int]] = []
        self._parity_holder: Dict[int, int] = {}
        self._parity_group_of: Dict[int, int] = {}
        self._parity_stale: set = set()
        self._parity_mirror = None
        self._parity_hot: List[int] = []
        if not self.parity_enabled:
            return
        # at construction the writers are seeded with exactly _img_cache
        # (init slices, or the stamped/replayed seeds on takeover)
        self._parity_mirror = self._mirror_from_images(self._img_cache)
        self._build_parity_groups(self.parity_group_size, hot_shards)
        self._reseed_parity(range(len(self._parity_groups)))
        if self.run_dir is not None:
            self._pending_manifest_events.append(self._parity_layout_event())

    @staticmethod
    def _mirror_from_images(images):
        return [([np.array(np.asarray(t)) for t in img[0]],
                 [np.array(np.asarray(a)) for a in img[1]])
                for img in images]

    def _build_parity_groups(self, group_size: int,
                             hot_shards: Sequence[int] = ()):
        """Partition the fleet into parity groups.  ``hot_shards`` (MFU
        tracker-ranked) get smaller, stronger groups — ``group_size // 2``
        members, so each hot stripe amortizes a failure over fewer peers;
        every group's holder is the first member of the NEXT group, which
        sits outside the group whenever there are >= 2 groups (a holder
        inside its own group still reconstructs any OTHER member)."""
        gs = max(1, min(int(group_size), self.n_shards))
        hot = [j for j in sorted({int(h) for h in hot_shards})
               if 0 <= j < self.n_shards]
        cold = [j for j in range(self.n_shards) if j not in set(hot)]
        hs = max(1, gs // 2)
        groups: List[List[int]] = []
        for pool, size in ((hot, hs), (cold, gs)):
            for i in range(0, len(pool), size):
                groups.append(pool[i:i + size])
        self._parity_groups = groups
        self._parity_group_of = {j: g for g, mem in enumerate(groups)
                                 for j in mem}
        self._parity_holder = {
            g: (groups[(g + 1) % len(groups)][0] if len(groups) > 1
                else groups[g][0])
            for g in range(len(groups))}
        self._parity_hot = hot
        self._parity_stale = set(range(len(groups)))    # until reseeded

    def _parity_layout_event(self) -> dict:
        """Coordinator-born manifest event recording the group layout —
        committed with the next cycle stamp so recovery tooling can see
        which shards protected which (replay skips unknown kinds)."""
        return {"kind": "parity-layout", "seq": self._next_seq(),
                "group_size": self.parity_group_size,
                "groups": [list(m) for m in self._parity_groups],
                "holders": {str(g): int(h)
                            for g, h in self._parity_holder.items()},
                "hot_shards": list(self._parity_hot)}

    def _compute_stripe(self, g: int):
        """The group's XOR stripe from the coordinator mirror: per table,
        stripe length = the widest member slice; members with fewer (or
        zero) rows contribute implicit zeros — identity parity, so empty
        shard slices never widen or crash the stripe."""
        members = self._parity_groups[g]
        tabs, accs = [], []
        for t in range(len(self.spec.table_sizes)):
            rows = max(self.ranges[j][t][1] - self.ranges[j][t][0]
                       for j in members)
            ref_t = self._parity_mirror[members[0]][0][t]
            ref_a = self._parity_mirror[members[0]][1][t]
            st = np.zeros((rows,) + ref_t.shape[1:], ref_t.dtype)
            sa = np.zeros((rows,) + ref_a.shape[1:], ref_a.dtype)
            for j in members:
                mt = self._parity_mirror[j][0][t]
                ma = self._parity_mirror[j][1][t]
                if len(mt):
                    xor_into(st[:len(mt)], mt)
                    xor_into(sa[:len(ma)], ma)
            tabs.append(st)
            accs.append(sa)
        return tabs, accs

    def _dispatch_parity(self, holder: int, op: str, payload) -> bool:
        """Route one parity frame to the holder unless it is — or just
        became — poisoned (same fail-stop isolation as ``_dispatch``)."""
        if not self._healthy(holder):
            return False
        ep = self.endpoints[holder]
        try:
            if op == "full":
                ep.submit_parity_full(*payload)
            else:
                ep.submit_parity_delta(*payload)
            return True
        except RuntimeError as e:
            self.failed[holder] = ep.error or e
            return False

    def _reseed_parity(self, groups):
        """(Re)ship the XOR stripes of ``groups`` — recomputed from the
        mirror — to their holders.  A group whose holder cannot accept the
        stripe stays/becomes stale (reconstruction refused) until a later
        reseed succeeds."""
        if not self.parity_enabled:
            return
        for g in sorted(set(groups)):
            holder = self._parity_holder[g]
            tabs, accs = self._compute_stripe(g)
            seq = self._next_seq()
            if self._dispatch_parity(holder, "full",
                                     (g, tabs, accs, 0, seq)):
                self._parity_stale.discard(g)
            else:
                self._parity_stale.add(g)

    def _parity_note_full(self, ok_shards):
        """``save_full`` parity leg (after the mirror advanced for the
        accepted shards): recut + reship every affected stripe — full
        saves already ship full snapshots fleet-wide, so the stripe
        reship is proportional traffic.  Stale groups self-heal here."""
        if not self.parity_enabled:
            return
        groups = set(self._parity_stale)
        for j in ok_shards:
            g = self._parity_group_of.get(j)
            if g is not None:
                groups.add(g)
        self._reseed_parity(groups)

    def _parity_row_update(self, j: int, table: int, rows, values,
                           acc_values, step: int, seq: int):
        """``save_rows`` parity leg for one accepted owner: advance the
        mirror and ship the XOR delta (old-bytes ^ new-bytes, stripe-local
        row ids) to the owner's group holder.  The mirror advances even
        for stale groups — it tracks what the member writer accepted, and
        the stripe is recut from it at the next reseed."""
        g = self._parity_group_of.get(j)
        if g is None:
            return
        lo, _ = self.ranges[j][table]
        local = np.asarray(rows) - lo
        mt = self._parity_mirror[j][0][table]
        ma = self._parity_mirror[j][1][table]
        xvals = xor_arrays(mt[local], np.asarray(values, mt.dtype))
        xaccs = xor_arrays(ma[local], np.asarray(acc_values, ma.dtype))
        mt[local] = values
        ma[local] = acc_values
        if g in self._parity_stale:
            return
        holder = self._parity_holder[g]
        if not self._dispatch_parity(
                holder, "delta", (g, table, local, xvals, xaccs, step, seq)):
            self._parity_stale.add(g)

    def configure_parity(self, group_size: Optional[int] = None,
                         hot_shards: Sequence[int] = ()) -> dict:
        """(Re)shape the parity layout at runtime — the policy hook the
        manager's MFU mode drives: tracker-hot shards get smaller,
        stronger groups.  Rebuilds the groups, reseeds every stripe from
        the mirror, and stamps a ``parity-layout`` manifest event with
        the next cycle.  Returns a layout summary dict."""
        if group_size is not None:
            self.parity_group_size = int(group_size)
            self.parity_enabled = (self.parity_group_size > 0 and
                                   self.n_shards >= 2)
        if not self.parity_enabled:
            self._parity_groups = []
            self._parity_holder = {}
            self._parity_group_of = {}
            self._parity_stale = set()
            return {"enabled": False}
        if self._parity_mirror is None:
            self._parity_mirror = self._mirror_from_images(
                [self._shard_images(j) for j in range(self.n_shards)])
        self._build_parity_groups(self.parity_group_size, hot_shards)
        self._reseed_parity(range(len(self._parity_groups)))
        if self.run_dir is not None:
            self._pending_manifest_events.append(self._parity_layout_event())
        return {"enabled": True,
                "groups": [list(m) for m in self._parity_groups],
                "holders": dict(self._parity_holder),
                "hot_shards": list(self._parity_hot),
                "stale": sorted(self._parity_stale)}

    def reconstruct_shard(self, j: int):
        """ECRM recovery: rebuild poisoned shard ``j``'s CURRENT image
        from its parity group's surviving peers — the holder's stripe XOR
        every surviving member's image — instead of replaying the last
        stamped cycle.  The result reflects every update the coordinator
        successfully submitted before the crash, including applied-but-
        unstamped work the stamped-replay path would lose.

        Reconstruction state machine (see docs/recovery.md): any failed
        precondition returns None and the caller falls back to
        stamped-replay (counted in ``parity_fallbacks``) —

        * parity on, ``j`` in a group, and the group's stripe not stale;
        * the stripe survives: the holder is healthy and is not ``j``
          itself (a double failure inside one group exceeds what single-
          stripe XOR can tolerate);
        * every OTHER member of the group is healthy and serves its
          image;
        * (delta saves on) the reconstructed rows hash-match the
          coordinator's per-row FNV ledger — defense in depth against a
          divergent stripe; a mismatch marks the group stale.

        The per-channel FIFO of the transports makes the fetched peer
        images and the holder stripe mutually consistent without a fence:
        both the ``image`` and ``parity-get`` reads are served only after
        everything submitted before them has been applied."""
        if not self.parity_enabled:
            return None
        g = self._parity_group_of.get(j)
        if g is None:
            return None
        if g in self._parity_stale:
            self.parity_fallbacks += 1
            return None
        holder = self._parity_holder[g]
        members = [m for m in self._parity_groups[g] if m != j]
        if holder == j or not self._healthy(holder) or \
                any(not self._healthy(m) for m in members):
            self.parity_fallbacks += 1
            return None
        stripe = self.endpoints[holder].fetch_parity(g, self._drain_timeout)
        if stripe is None or len(stripe[0]) != len(self.ranges[j]) or any(
                len(stripe[0][t]) < (hi - lo)
                for t, (lo, hi) in enumerate(self.ranges[j])):
            self._parity_stale.add(g)
            self.parity_fallbacks += 1
            return None
        images = {}
        for m in members:
            got = self.endpoints[m].fetch_image(self._drain_timeout)
            if got is None:
                self.failed[m] = self.endpoints[m].error
                self.parity_fallbacks += 1
                return None
            images[m] = got
        rec_t, rec_a = [], []
        for t, (lo, hi) in enumerate(self.ranges[j]):
            cnt = hi - lo
            st = np.array(stripe[0][t][:cnt])
            sa = np.array(stripe[1][t][:cnt])
            for m in members:
                it, ia = images[m][0][t], images[m][1][t]
                k = min(len(it), cnt)
                if k:
                    xor_into(st[:k], it[:k])
                    xor_into(sa[:k], ia[:k])
            rec_t.append(st)
            rec_a.append(sa)
        if self._hashes is not None:
            for t, (lo, hi) in enumerate(self.ranges[j]):
                if hi > lo and not torch.equal(
                        self._hash(rec_t[t], rec_a[t]),
                        self._hashes[t][lo:hi]):
                    self._parity_stale.add(g)
                    self.parity_fallbacks += 1
                    return None
        # the trainer replica (shard 0) is not parity-striped: the last
        # fetched copy rides along; a disk-mode recovery that needs the
        # stamped MLPs replays them through the normal chain
        trainer = self._img_cache[j][2]
        self.parity_reconstructions += 1
        return rec_t, rec_a, trainer

    @property
    def parity_bytes(self) -> int:
        """Stripe bytes accepted by holder writers (soft state: counted
        separately from ``bytes_written`` — parity never hits disk)."""
        return sum(getattr(ep, "parity_bytes", 0) for ep in self.endpoints)

    @property
    def parity_report(self) -> dict:
        return {"enabled": self.parity_enabled,
                "group_size": self.parity_group_size,
                "groups": [list(m) for m in self._parity_groups],
                "holders": {int(g): int(h)
                            for g, h in self._parity_holder.items()},
                "hot_shards": list(self._parity_hot),
                "stale_groups": sorted(self._parity_stale),
                "reconstructions": self.parity_reconstructions,
                "fallbacks": self.parity_fallbacks,
                "parity_bytes": self.parity_bytes}

    # ------------------------------------------------------------ routing --
    def _next_seq(self) -> int:
        with self._seq_lock:
            self._seq += 1
            return self._seq

    def _healthy(self, j: int) -> bool:
        """Poisoned-shard check at routing time (fail-stop isolation): a
        latched worker error — or a dead writer process / lost connection —
        drops this shard out of the fleet; everyone else keeps saving."""
        if j in self.failed:
            return False
        err = self.endpoints[j].error
        if err is not None:
            self.failed[j] = err
            return False
        return True

    def _dispatch(self, j: int, kind: str, payload) -> bool:
        """Route one command to shard ``j`` unless it is — or just became —
        poisoned.  A worker error latching between the health check and the
        enqueue is treated exactly like one seen earlier: dropped and
        recorded, never a crash."""
        if not self._healthy(j):
            return False
        ep = self.endpoints[j]
        try:
            {"full": ep.submit_full, "rows": ep.submit_rows,
             "trainer": ep.submit_trainer}[kind](*payload)
            return True
        except RuntimeError as e:
            self.failed[j] = ep.error or e
            return False

    @staticmethod
    def _snap(a):
        """Host snapshot that the caller cannot mutate afterwards.  A CUDA
        tensor is copied into page-locked memory from PyTorch's caching
        host allocator: the next full save reuses the buffers this one
        frees, where fresh pageable memory would be faulted in page by page
        on every save (2.3 GB at full Criteo-Kaggle width), and the copy
        runs at the link's DMA rate."""
        if isinstance(a, torch.Tensor) and a.is_cuda:
            out = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
            return out.copy_(a.detach()).numpy()
        return host_copy(a)

    def save_full(self, tables, accs, trainer_state=None, step: int = 0):
        """One immutable host snapshot per table, shipped fleet-wide by the
        transport (each shard slices out its own ranges off the critical
        path); returns enqueued snapshot bytes (poisoned shards' slices are
        dropped, not counted)."""
        seq = self._next_seq()
        snap_t = [self._snap(t) for t in tables]
        snap_a = [self._snap(a) for a in accs]
        full_h = (self._hash_tables(tables, accs)
                  if self._hashes is not None else None)
        ref = self.transport.make_snapshot(seq, snap_t, snap_a)
        nbytes = 0
        ok_shards = []
        for j in range(self.n_shards):
            part = sum(snap_t[t][lo:hi].nbytes + snap_a[t][lo:hi].nbytes
                       for t, (lo, hi) in enumerate(self.ranges[j]))
            if not self._dispatch(j, "full", (ref, step, seq)):
                self.dropped_bytes += part
                continue
            nbytes += part
            ok_shards.append(j)
            if full_h is not None:
                for t, (lo, hi) in enumerate(self.ranges[j]):
                    self._hashes[t][lo:hi] = full_h[t][lo:hi]
        if self.parity_enabled:
            # mirror advance rides the same accepted-shards-only contract
            # as the hash advance: a dropped slice must not be treated as
            # shipped by a later delta or stripe recut
            for j in ok_shards:
                for t, (lo, hi) in enumerate(self.ranges[j]):
                    self._parity_mirror[j][0][t][...] = snap_t[t][lo:hi]
                    self._parity_mirror[j][1][t][...] = snap_a[t][lo:hi]
            self._parity_note_full(ok_shards)
        if trainer_state is not None:
            snap_tr = tree.tree_map(self._snap, trainer_state)
            if self._dispatch(0, "trainer", (snap_tr, step, seq)):
                nbytes += sum(np.asarray(a).nbytes
                              for a in _leaves(snap_tr))
        return nbytes

    def save_trainer(self, trainer_state, step: int = 0):
        """Snapshot + enqueue a trainer-replica save to shard 0 (priority
        modes never run ``save_full``; the manager ships the MLPs here at
        T_save boundaries so disk recovery is complete)."""
        if trainer_state is None:
            return 0
        snap = tree.tree_map(self._snap, trainer_state)
        if not self._dispatch(0, "trainer", (snap, step, self._next_seq())):
            return 0
        return sum(np.asarray(a).nbytes for a in _leaves(snap))

    def save_rows(self, table: int, rows, values, acc_values, step: int = 0):
        """Route a partial (priority) save to the owning shards; returns
        enqueued snapshot bytes after delta filtering.

        With delta saves the rows are put on the ledger's device (no copy
        for tensors already there): out-of-range rows are dropped, the
        rows hashed and compared against the ledger there, and only the
        changed rows are copied to the host."""
        if self._hashes is not None:
            rows, values, acc_values, h, rows_dev = self._delta(
                table, rows, values, acc_values)
        else:
            rows = _host(rows)
            valid = (rows >= 0) & (rows < self.spec.table_sizes[table])
            rows = rows[valid]                 # fancy indexing: fresh copies
            values = _host(values)[valid]
            acc_values = _host(acc_values)[valid]
        if rows.size == 0:
            return 0
        seq = self._next_seq()
        owners = self.spec.shard_of_rows(table, rows)
        nbytes = 0
        accepted = np.zeros(rows.size, bool)
        for j in np.unique(owners):
            m = owners == j
            part = values[m].nbytes + acc_values[m].nbytes + rows[m].nbytes
            if not self._dispatch(int(j), "rows", (table, rows[m], values[m],
                                                   acc_values[m], step, seq)):
                self.dropped_bytes += part
                continue
            nbytes += part
            accepted |= m
            if self.parity_enabled:
                self._parity_row_update(int(j), table, rows[m], values[m],
                                        acc_values[m], step, seq)
        if self._hashes is not None and accepted.any():
            # advance the delta hashes only for rows a healthy shard
            # actually accepted — dropped rows must not be skipped as
            # "already saved" later
            if not accepted.all():
                keep = self._on_ledger(accepted)
                rows_dev, h = rows_dev[keep], h[keep]
            self._hashes[table][rows_dev.long()] = h
        return nbytes

    def _delta(self, table: int, rows, values, acc_values):
        """The delta skip on the ledger's device: only the changed rows
        cross to the host.  Returns host (rows, values, accs), the changed
        rows' hashes and their row ids, both on the ledger's device."""
        rows = self._on_ledger(rows)
        values = self._on_ledger(values)
        acc_values = self._on_ledger(acc_values)
        valid = (rows >= 0) & (rows < self.spec.table_sizes[table])
        if not bool(valid.all()):
            rows, values, acc_values = (rows[valid], values[valid],
                                        acc_values[valid])
        h = self._hash(values, acc_values)
        changed = h != self._hashes[table][rows.long()]
        n_skip = rows.numel() - int(changed.sum())
        if n_skip:
            self.delta_rows_skipped += n_skip
            self.delta_bytes_skipped += n_skip * (
                _row_nbytes(values) + _row_nbytes(acc_values) +
                rows.element_size())
            rows, values, acc_values, h = (rows[changed], values[changed],
                                           acc_values[changed], h[changed])
        return (host_copy(rows), host_copy(values), host_copy(acc_values),
                h, rows)

    # ----------------------------------------------------------- health ----
    def _heartbeat_loop(self):
        """Monitor thread: probe endpoints so a writer that died between
        saves is latched proactively.  Deliberately latches the ENDPOINT
        only — ``self.failed`` is owned by the trainer thread (fences
        iterate it unlocked), so the fold into the poisoned set happens at
        the next routing/fence/``check_health`` call.  A latched endpoint
        is already out of the fleet for every practical purpose: submits
        to it drop immediately."""
        while not self._hb_stop.wait(self.heartbeat_interval):
            self._probe_sweep()
            if self._closing or self._closed:
                return

    def _probe_sweep(self):
        """One monitor probe sweep, serialized against the fence's DRAIN
        window and against close() via ``_monitor_lock`` — and a no-op
        once close() has begun.  Without both guards an aggressive
        ``heartbeat_interval`` could latch a shard "dead" from the silence
        of its own mid-drain work, or probe a writer that close() is
        already shutting down — turning a clean shutdown into a spurious
        poison and a ``failed_shards`` entry in the final cycle stamp."""
        if not self._monitor_lock.acquire(blocking=False):
            return                      # a fence/close owns the fleet now;
        try:                            # skip the sweep, don't queue on it
            if self._closing or self._closed:
                return
            for j, ep in enumerate(self.endpoints):
                if j not in self.failed and ep.error is None:
                    try:
                        ep.probe()
                    # lint: allow[exception-hygiene] a probe failure is not
                    # a crash; real writer death latches ep.error itself
                    except Exception:
                        pass            # a probe failure is not a crash
            try:
                self._renew_lease()     # stay elected while merely idle
            except OSError:
                pass
        finally:
            self._monitor_lock.release()

    def check_health(self) -> List[int]:
        """One probe sweep on the caller's (trainer) thread: latch dead
        endpoints and fold them into the poisoned set.  Returns the newly
        poisoned shard ids."""
        newly = []
        for j, ep in enumerate(self.endpoints):
            if j in self.failed:
                continue
            ep.probe()
            if ep.error is not None:
                self.failed[j] = ep.error
                newly.append(j)
        return newly

    # -------------------------------------------------- coordinator fence --
    def _drain(self) -> List[dict]:
        """Phase 1 of the fence: the DRAIN barrier.

        *Broadcast* the DRAIN marker to every healthy shard first, then
        collect each one's ``drained`` ack — shards drain concurrently, and
        the ack's watermark confirms apply, persist **and payload fsync**
        up to that seq.  (Inproc endpoints implement the ack as a queue
        join + batched fsync on the caller thread.)  A shard that cannot
        ack is poisoned here, and the acked events of every shard
        (including ones that died after acking) are returned for stamping.
        """
        with self._monitor_lock:        # monitor stands down for the fence
            self._drain_token += 1
            token = self._drain_token
            pending = []
            for j, ep in enumerate(self.endpoints):
                if j in self.failed:
                    continue
                if ep.begin_drain(token):
                    pending.append(j)
                else:
                    self.failed[j] = ep.error
            for j in pending:
                if not self.endpoints[j].finish_drain(token,
                                                      self._drain_timeout):
                    self.failed[j] = self.endpoints[j].error
            drained: List[dict] = []
            for j, ep in enumerate(self.endpoints):
                # a dead/poisoned worker may have acked durable applies the
                # coordinator never pumped — fold them so they are stamped,
                # whatever the transport
                ep.pump()
                evs = ep.collect_applied()
                drained.extend(evs)
                for e in evs:
                    self._watermarks[j] = max(self._watermarks[j], e["seq"])
                self._watermarks[j] = max(self._watermarks[j],
                                          ep.durable_seq)
            return drained

    def _fsync_failed_shards_payloads(self, drained: List[dict]):
        """A poisoned shard never answered this DRAIN, so its acked events'
        payloads were persisted but not fsynced by the worker.  fsync them
        from the coordinator before they are stamped — the stamp must never
        cover a payload the page cache could still lose.

        Scope: this backstop needs the shard's directory to be visible on
        the coordinator's filesystem — always true for inproc/pipe, and
        for socket only with local/shared storage.  A remote socket writer
        on a private disk that dies between its last ack and the DRAIN ack
        leaves those stamped events crash-true but not power-loss-true
        (fsync_path no-ops on the nonexistent local path); see
        docs/recovery.md."""
        if not (self.run_dir and self.fsync_payloads and self.failed):
            return
        dirs = set()
        for e in drained:
            j = e.get("shard")
            if j not in self.failed:
                continue
            fname = e.get("file") or (f"full_e{e['seq']}.npz"
                                      if e["kind"] == "full" else None)
            if fname:
                d = os.path.join(self.run_dir, f"shard_{j}")
                fsync_path(os.path.join(d, fname))
                dirs.add(d)
        for d in dirs:
            fsync_path(d)

    def fence(self, strict: bool = True):
        """Two-phase coordinator fence (the DRAIN/STAMP barrier).

        Phase 1 (:meth:`_drain`) broadcasts DRAIN and collects every
        healthy shard's durable watermark.  Phase 2 flushes the acked
        events into the coordinator manifest, in global ``seq`` order, and
        stamps a ``cycle`` record carrying the watermarks — the consistency
        point ``load_latest`` recovers to — only once every healthy shard
        has acked.  The first stamped cycle of a run atomically advances
        the root ``CURRENT`` pointer to this run.  With ``strict`` (the
        default) a :class:`ShardSaveError` is then raised if any shard is
        poisoned; the healthy shards were already drained and stamped, so
        their saves are never lost to another writer's error.
        """
        if self._closed:
            # close() already drained + stamped the final cycle; a later
            # fence (e.g. report() after the emulator shut the fleet down)
            # must not mistake the cleanly-exited workers for crashes
            if strict and self.failed:
                raise ShardSaveError(self.failed)
            return
        # events a quiesce() already popped off the workers ride this
        # fence's atomic manifest write (they would otherwise be lost)
        drained = self._pending_drained + self._drain()
        self._pending_drained = []
        if self.run_dir is not None:
            # split-brain guard: a coordinator whose epoch has been
            # superseded on disk (a standby attached) must never stamp —
            # refusing HERE, before the manifest or CURRENT is touched,
            # is what makes the wire-level stale rejections transitive to
            # STAMP on every transport (a pipe writer only knows its own
            # coordinator, but that coordinator cannot commit)
            self._assert_coordinator_ownership()
            # coordinator-born events (layout stamps) commit in the SAME
            # atomic write as this cycle; they carry no shard
            drained.extend(self._pending_manifest_events)
            self._pending_manifest_events = []
            drained.sort(key=lambda e: (e["seq"], e.get("shard", -1)))
            self._fsync_failed_shards_payloads(drained)
            self._manifest["events"].extend(drained)
            self.cycle += 1
            self._manifest["events"].append({
                "kind": "cycle", "cycle": self.cycle, "epoch": self.epoch,
                "time": time.time(),
                "shard_seq": {str(j): self._watermarks[j]
                              for j in range(self.n_shards)},
                "failed_shards": sorted(self.failed)})
            # atomic durable rewrite (fsync data + dir before/after the
            # rename).  Together with the workers' payload fsync at DRAIN
            # (and _fsync_failed_shards_payloads for shards that died with
            # acked-but-unsynced events), the stamp and everything it
            # references survive power loss, not just process crashes.
            atomic_json_dump(os.path.join(self.run_dir, "manifest.json"),
                             self._manifest)
            if not self._current_advanced:
                # only now may recovery prefer this run over its parent
                _write_current(self.root_dir, self._manifest["run"])
                self._current_advanced = True
            self._persist_coordinator_state()
            self._renew_lease()
        # every healthy shard acked past the pending save_full snapshots;
        # poisoned ones will never read them (their queued work was
        # dropped) — release the shm segments / spool files
        self.transport.release_pending()
        # a shard that stayed healthy through a whole stamped cycle is
        # stable again: its crash-loop back-off clock starts over
        for j in range(self.n_shards):
            if j not in self.failed:
                self._readmit_attempts[j] = 0
        if strict and self.failed:
            raise ShardSaveError(self.failed)

    def quiesce(self) -> int:
        """Drain every healthy shard — all queued applies done, payloads
        fsynced, watermarks collected — WITHOUT stamping a cycle.  After a
        quiesce the peer images and holder stripes reflect everything
        submitted so far while the recovery point stays at the LAST
        stamped cycle: exactly the window the fig15 ``bytes_lost_at_crash``
        benchmark measures (parity-reconstruct recovers the quiesced
        state; stamped-replay rolls back to the stamp).

        The drained events are stashed and merged into the next
        ``fence()``'s atomic manifest write: ``collect_applied`` pops the
        workers' ack lists, so dropping them here would silently erase
        acked saves from the stamped history.  Returns the number of
        events drained."""
        drained = self._drain()
        self._pending_drained.extend(drained)
        return len(drained)

    def _assert_coordinator_ownership(self):
        """Raise :class:`StaleCoordinatorError` when a newer epoch exists —
        either in the durable ``COORDINATOR`` record or as a bare
        ``.epoch-<n>.claim`` marker.  The marker check is what closes the
        takeover window: a standby drops its O_EXCL marker *before* any
        adoption/reseed work, so a hung predecessor that un-hangs
        mid-takeover is already fenced off even though the successor has
        not yet rewritten the record."""
        if not self.root_dir:
            return
        disk = _read_coordinator_state(self.root_dir)
        if disk is not None and int(disk.get("epoch", 0)) > self.epoch:
            raise StaleCoordinatorError(
                f"coordinator epoch {self.epoch} superseded by epoch "
                f"{disk['epoch']} (run {disk.get('run')!r}): refusing to "
                f"stamp — the fleet belongs to the successor")
        claimed = _newest_claim_epoch(self.root_dir)
        if claimed > self.epoch:
            raise StaleCoordinatorError(
                f"coordinator epoch {self.epoch} superseded by a claim "
                f"for epoch {claimed}: refusing to stamp — a successor "
                f"is taking over the fleet")

    def _persist_coordinator_state(self):
        """Atomically rewrite the ``COORDINATOR`` record (epoch, shard
        registry, last stamp, re-admission ledger) next to ``CURRENT``.
        No-op once this epoch has been superseded on disk — a stale
        coordinator must not clobber its successor's claim.  (The
        read-check-write here is not atomic, but stamping correctness
        never rests on this record alone: the race-free claim markers
        fence a superseded coordinator at ``_assert_coordinator_ownership``
        even if its in-flight persist regresses the record.)"""
        if not self.root_dir:
            return
        disk = _read_coordinator_state(self.root_dir)
        if disk is not None and int(disk.get("epoch", 0)) > self.epoch:
            return
        if _newest_claim_epoch(self.root_dir) > self.epoch:
            return
        state = {
            "layout": LAYOUT,
            "epoch": self.epoch,
            "run": self._manifest["run"],
            "backend": self.backend,
            "n_shards": self.n_shards,
            "table_sizes": list(self.spec.table_sizes),
            "layout_epoch": self.layout_epoch,
            "boundaries": [b.tolist() for b in self.spec.boundaries],
            "cycle": self.cycle,
            "shard_seq": {str(j): self._watermarks[j]
                          for j in range(self.n_shards)},
            "addresses": self.transport.addresses,
            "readmissions": self.shard_readmissions,
            "readmit_attempts": list(self._readmit_attempts),
            "failed_shards": sorted(self.failed),
            "time": time.time(),
        }
        atomic_json_dump(os.path.join(self.root_dir, COORDINATOR_PTR),
                         state)

    # ------------------------------------------------- lease (election) --
    def _renew_lease(self):
        """Refresh the coordinator lease (opt-in via ``lease_ttl``):
        called at claim, at every stamp, and from the heartbeat sweep so
        an idle-but-alive coordinator stays elected.  Never renews over a
        newer epoch's lease — a superseded coordinator lets its claim
        lapse instead of fighting the successor."""
        if not (self.root_dir and self.lease_ttl) or self._closed:
            return
        cur = lease_status(self.root_dir)
        if cur is not None and int(cur.get("epoch", 0)) > self.epoch:
            return
        atomic_json_dump(os.path.join(self.root_dir, LEASE_PTR), {
            "epoch": self.epoch, "run": self._manifest["run"],
            "ttl": self.lease_ttl,
            "expires": time.time() + self.lease_ttl,
            "time": time.time()})

    def _release_lease(self):
        """Clean shutdown: expire the lease NOW so a standby need not
        wait out the TTL before taking over."""
        if not (self.root_dir and self.lease_ttl):
            return
        cur = lease_status(self.root_dir)
        if cur is not None and int(cur.get("epoch", 0)) > self.epoch:
            return
        try:
            atomic_json_dump(os.path.join(self.root_dir, LEASE_PTR), {
                "epoch": self.epoch, "run": self._manifest["run"],
                "ttl": self.lease_ttl, "expires": 0.0,
                "time": time.time()})
        except OSError:
            pass

    def close(self):
        """Stamp a final cycle and stop the workers; never raises
        (idempotent)."""
        if self._closed:
            return
        self._closing = True            # monitor sweeps stand down NOW —
        #                                 even one that outlives the join
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2.0)
        try:
            self.fence(strict=False)
        # lint: allow[exception-hygiene] best-effort final fence on close;
        # shard errors were already latched on the endpoints by the fence
        except Exception:
            pass
        self._release_lease()
        self._closed = True
        self.transport.close()

    # ------------------------------------------------------- re-admission --
    def kill_shard(self, j: int):
        """Failure drill: hard-kill shard ``j``'s writer (SIGKILL for the
        pipe/socket transports, a latched poison for inproc).  The
        crash-injection suite and operator drills drive this; recovery must
        behave exactly as for a real writer death."""
        self.endpoints[j].kill()
        self.failed[j] = self.endpoints[j].error

    def readmit(self, tables, accs, trainer_state=None, step: int = 0):
        """Re-admit poisoned shards into the fleet (call at a cycle
        boundary, after ``fence``).

        Per poisoned shard: (1) the writer is respawned — a fresh process /
        connection seeded from the shard's last-good image: the parity
        ``reconstruct`` path first (surviving peers' data + XOR stripe
        rebuild the shard's CURRENT image — zero rollback), then disk
        replay of stamped events, then the fetch cache (see
        :meth:`reconstruct_shard` for the fallback rules); inproc uses a
        fresh applier thread over the surviving store; (2) a **fresh full
        of the shard's current
        rows** is enqueued, covering every row the shard missed while
        poisoned, and the delta hashes for its ranges are re-based on that
        snapshot; (3) the shard leaves ``failed`` and resumes normal
        routing.  The reseed full is stamped — and the shard's recovery
        point caught up — at the *next* fence.

        Respawn failure is **atomic**: the shard stays poisoned (latched
        with the respawn error) and is retried at a later boundary — it is
        never left half-registered.  With ``readmit_backoff`` a shard's
        consecutive re-admissions are throttled exponentially (base
        doubling per attempt, capped at ``readmit_backoff_max``; the
        counter resets once the shard stays healthy for a stamped cycle) so
        a crash-looping shard cannot thrash the fleet.  Returns the
        successfully re-admitted shard ids.
        """
        if not self.failed:
            return []
        candidates = sorted(self.failed)
        seq = self._next_seq()
        snap_t = [self._snap(t) for t in tables]
        snap_a = [self._snap(a) for a in accs]
        ref = None
        readmitted = []
        now = time.monotonic()
        for j in candidates:
            if self.readmit_backoff > 0 and now < self._readmit_not_before[j]:
                continue                       # still backing off
            ep = self.endpoints[j]
            self._note_readmit_attempt(j, now)
            try:
                if self.transport.is_remote:
                    seed_t, seed_a, seed_tr = self._shard_images(j)
                    ep.respawn(seed_t, seed_a, seed_tr)
                else:
                    ep.respawn(None, None)
            except BaseException as e:
                # atomic failure: the endpoint (re)latched itself; the
                # shard stays poisoned and retries at a later boundary
                ep.poison(e)
                self.failed[j] = ep.error or e
                continue
            del self.failed[j]
            if ref is None:
                ref = self.transport.make_snapshot(seq, snap_t, snap_a)
            if self._dispatch(j, "full", (ref, step, seq)):
                if self._hashes is not None:
                    for t, (lo, hi) in enumerate(self.ranges[j]):
                        self._hashes[t][lo:hi] = self._hash(tables[t][lo:hi],
                                                            accs[t][lo:hi])
                if self.parity_enabled:
                    for t, (lo, hi) in enumerate(self.ranges[j]):
                        self._parity_mirror[j][0][t][...] = snap_t[t][lo:hi]
                        self._parity_mirror[j][1][t][...] = snap_a[t][lo:hi]
                if j == 0 and trainer_state is not None:
                    self.save_trainer(trainer_state, step=step)
            readmitted.append(j)
        if readmitted and self.parity_enabled:
            # a readmitted MEMBER's group stripe must be recut (its fresh
            # full re-based the slice); a readmitted HOLDER lost its held
            # stripes with the process — reseed those groups too, plus
            # anything marked stale while the fleet was degraded.  The
            # crash-loop throttle is deliberately untouched here: a
            # successful reconstruction/reseed only zeroes the backoff
            # once the shard survives a full stamped cycle (fence()) —
            # a reconstruct-then-die loop keeps backing off exponentially.
            affected = {self._parity_group_of[j] for j in readmitted
                        if j in self._parity_group_of}
            affected |= {g for g, h in self._parity_holder.items()
                         if h in readmitted}
            self._reseed_parity(affected | self._parity_stale)
        self.shard_readmissions += len(readmitted)
        if readmitted and self.root_dir:
            # a respawned auto-spawned socket server binds a new port:
            # refresh the durable shard registry so a later takeover
            # attaches to the live fleet, not the dead addresses
            self._persist_coordinator_state()
        return readmitted

    def _note_readmit_attempt(self, j: int, now: float):
        """Crash-loop throttle bookkeeping: one attempt (successful or not)
        schedules the shard's next eligibility exponentially further out —
        unless the shard had been stable for ``readmit_backoff_max``, which
        starts the sequence over."""
        if self.readmit_backoff <= 0:
            return
        if (self._last_readmit_t[j] and
                now - self._last_readmit_t[j] > self.readmit_backoff_max):
            self._readmit_attempts[j] = 0
        self._readmit_attempts[j] += 1
        delay = min(self.readmit_backoff *
                    (2 ** (self._readmit_attempts[j] - 1)),
                    self.readmit_backoff_max)
        self._readmit_not_before[j] = now + delay
        self._last_readmit_t[j] = now

    # ----------------------------------------------------------- restores --
    def restore_shards(self, tables, accs, shard_ids: Sequence[int]):
        """Partial recovery: revert only the failed shards' row ranges from
        their writers' images.  Fence first (the manager does).

        Unlike the reference, which returns new numpy copies, this writes
        the image rows into the caller's tensors (or arrays) **in place**
        and returns the same lists, as the port's flat store does."""
        for j in shard_ids:
            img_t, img_a, _ = self._shard_images(j)
            for t, (lo, hi) in enumerate(self.ranges[j]):
                if hi > lo:
                    _write_slice(tables[t], lo, hi, img_t[t])
                    _write_slice(accs[t], lo, hi, img_a[t])
        return tables, accs

    def restore_all(self):
        """Full recovery image (every shard + trainer replica), fetched in
        a single per-shard sweep."""
        images = [self._shard_images(j) for j in range(self.n_shards)]
        tabs, accs = self._assemble(images)
        return tabs, accs, images[0][2]

    # ------------------------------------------------- elastic resharding --
    def resize(self, n_shards: int, step: int = 0,
               addresses: Optional[Sequence] = None,
               block: bool = True) -> dict:
        """Online split/merge of the writer fleet (a new **layout epoch**),
        inside one fence window — the trainer pauses for this call and
        nothing else; no restart, no full-run rollback.

        Protocol: (1) ``fence`` lands the fleet on a stamped cycle under
        the OLD layout — the rollback point a crash mid-reshard recovers
        to; (2) the stamped global image is collected (remote donors
        stream their own row ranges over the peer-transfer ``export``
        frames; shard 0 also ships the trainer replica; dead or local
        shards fall back to the coordinator-side image); (3) the
        transport resharding swap: retained writers swap their store to
        the new boundaries *in place* (``reshard`` frames — session and
        connection survive), growth shards spawn fresh, surplus writers
        retire; (4) coordinator state re-bases: ranges, delta hashes,
        watermarks, restore caches, re-admission ledger; (5) a full of
        every new shard is enqueued and the next fence commits **layout
        event + seed fulls + cycle stamp in ONE atomic manifest write** —
        recovery either sees the whole new epoch or none of it.

        Returns an info dict (``from``/``to``/``layout_epoch``/
        ``pause_s``/``moved_bytes``/``cycle``), also appended to
        ``reshard_history``.  Raises :class:`ShardSaveError` if any
        resized writer failed (the healthy ones were stamped)."""
        if self._closed:
            raise RuntimeError("cannot resize a closed writer")
        new_spec = EmbShardSpec(self.spec.table_sizes, int(n_shards))
        if new_spec.same_layout(self.spec):
            return {"from": self.n_shards, "to": self.n_shards,
                    "layout_epoch": self.layout_epoch, "pause_s": 0.0,
                    "moved_bytes": 0, "cycle": self.cycle}
        t0 = time.perf_counter()
        # (1) stamp the old layout: the crash rollback point
        self.fence(strict=False)
        # (2) collect the stamped global image from the donors
        n_tables = len(self.spec.table_sizes)
        moved = 0
        images = []
        for j in range(self.n_shards):
            got = None
            if (j != 0 and self.transport.is_remote and
                    j not in self.failed and
                    self.endpoints[j].error is None):
                try:
                    got = self.endpoints[j].export_rows(
                        [self.ranges[j][t] for t in range(n_tables)],
                        timeout=self._drain_timeout)
                except NotImplementedError:
                    got = None
            img = ((got[0], got[1], None) if got is not None
                   else self._shard_images(j))
            images.append(img)
            moved += sum(np.asarray(a).nbytes
                         for part in img[:2] for a in part)
        g_t, g_a = self._assemble(images)
        g_tr = images[0][2]
        # (3) pristine init image re-cut under the NEW layout: the
        # disk-replay base and the resized fleet's spawn seeds
        init_t, init_a = self._assemble(self._init_slices)
        init_tr = self._init_slices[0][2]
        new_n = new_spec.n_shards
        new_ranges = [[new_spec.shard_range(t, j)
                       for t in range(n_tables)] for j in range(new_n)]
        new_seeds = [
            ([np.array(init_t[t][lo:hi])
              for t, (lo, hi) in enumerate(new_ranges[j])],
             [np.array(init_a[t][lo:hi])
              for t, (lo, hi) in enumerate(new_ranges[j])],
             init_tr if j == 0 else None)
            for j in range(new_n)]
        new_dirs = [os.path.join(self.run_dir, f"shard_{j}")
                    if self.run_dir else None for j in range(new_n)]
        # the monitor stands down for the swap (a probe mid-reshard
        # would mistake a writer's store swap for silence)
        with self._monitor_lock:
            self.transport.resize_fleet(new_spec, new_seeds, new_dirs,
                                        addresses=addresses)
            self.endpoints = self.transport.endpoints
        # (4) re-base every piece of per-shard coordinator state
        old_n = self.n_shards
        self.spec = new_spec
        self.n_shards = new_n
        self.ranges = new_ranges
        self._init_slices = new_seeds
        self._img_cache = [
            ([np.array(g_t[t][lo:hi])
              for t, (lo, hi) in enumerate(new_ranges[j])],
             [np.array(g_a[t][lo:hi])
              for t, (lo, hi) in enumerate(new_ranges[j])],
             g_tr if j == 0 else None)
            for j in range(new_n)]
        self._watermarks = [0] * new_n
        self.failed = {j: ep.error for j, ep in enumerate(self.endpoints)
                       if ep.error is not None}
        self._readmit_attempts = [0] * new_n
        self._readmit_not_before = [0.0] * new_n
        self._last_readmit_t = [0.0] * new_n
        if self._hashes is not None:
            self._hashes = [self._hash(t, a) for t, a in zip(g_t, g_a)]
        self.parity_enabled = (self.parity_group_size > 0 and new_n >= 2)
        if self.parity_enabled:
            # re-partition parity under the new layout: the mirror is
            # re-cut from the stamped global image (so a shard that fails
            # before its seed full lands still reconstructs to the
            # stamp), groups/holders rebuilt, stripes reseeded by the
            # seed save_full below (hot-shard tuning re-applies at the
            # manager's next policy pass)
            self._parity_mirror = self._mirror_from_images(self._img_cache)
            self._build_parity_groups(self.parity_group_size)
            if self.run_dir is not None:
                self._pending_manifest_events.append(
                    self._parity_layout_event())
        else:
            self._parity_groups = []
            self._parity_holder = {}
            self._parity_group_of = {}
            self._parity_stale = set()
            self._parity_mirror = None
        self.layout_epoch += 1
        if self.run_dir is not None:
            self._manifest["n_shards"] = new_n
            self._pending_manifest_events.append({
                "kind": "layout", "seq": self._next_seq(),
                "layout_epoch": self.layout_epoch, "n_shards": new_n,
                "boundaries": [b.tolist() for b in new_spec.boundaries],
                "parent": self.layout_epoch - 1})
        # (5) seed fulls for every resized shard, then ONE atomic stamp.
        # With ``block=False`` the stamping fence rides the next natural
        # cycle boundary instead: the appliers persist the seeds in the
        # background and the caller's pause ends at the enqueue — a crash
        # before that fence recovers to the pre-reshard stamp of step (1).
        self.save_full(g_t, g_a, trainer_state=g_tr, step=step)
        if block:
            self.fence(strict=False)
        info = {"from": old_n, "to": new_n,
                "layout_epoch": self.layout_epoch,
                "pause_s": time.perf_counter() - t0,
                "moved_bytes": int(moved), "cycle": self.cycle}
        self.reshard_history.append(info)
        if block and self.failed:
            raise ShardSaveError(self.failed)
        return info

    # ----------------------------------------------------------- failover --
    @classmethod
    def attach(cls, directory: str, tables, accs, spec: EmbShardSpec,
               trainer_state=None, backend: Optional[str] = None,
               addresses: Optional[Sequence] = None, force: bool = False,
               **kw) -> "ShardedCheckpointWriter":
        """Standby-coordinator takeover of a live writer fleet.

        Reads the durable ``COORDINATOR`` record next to ``CURRENT`` (the
        predecessor's shard registry, epoch, last stamped cycle and
        re-admission ledger), claims the next **epoch**, and builds a new
        coordinator that *adopts* the still-running writers instead of
        respawning the world:

        * **socket**: re-handshake with each registered ``shard_server``
          (``attach``/``reconcile``): a writer whose durable watermark
          equals the last stamp is kept in place (no state crosses the
          wire); a writer with a gap of applied-but-unstamped work is
          reseeded with the stamped image replayed from disk — the gap is
          discarded, never resurrected.  A server with no parked session
          (restarted since) gets a fresh spawn seeded the same way.
        * **pipe** / **inproc**: the predecessor's writers died with its
          process; fresh writers are spawned from the stamped images.

        Either way the fleet lands exactly on the last stamped cycle and
        resumes fencing under the new epoch; the predecessor — should it
        un-hang — is rejected at every writer frame (socket) and at its
        next stamp attempt (every transport).  ``tables``/``accs`` are the
        pristine *initial* values (the disk-replay base), exactly as for
        :meth:`load_latest`; read the recovered state back with
        ``restore_all``.  The takeover outcome is in ``attach_report``.
        """
        lease = lease_status(directory)
        if not force and lease is not None and lease.get("held"):
            raise LeaseHeldError(
                f"coordinator epoch {lease.get('epoch')} holds a live "
                f"lease on {directory} (expires in "
                f"{float(lease.get('expires', 0)) - time.time():.1f}s): "
                f"the active coordinator is alive — this standby lost "
                f"the election (pass force=True to take over anyway)")
        state = _read_coordinator_state(directory)
        if state is None:
            raise FileNotFoundError(
                f"no coordinator state in {directory} (no "
                f"{COORDINATOR_PTR} record): nothing to attach to — "
                f"start a fresh coordinator instead")
        if list(state.get("table_sizes", spec.table_sizes)) != \
                list(spec.table_sizes):
            raise ValueError(
                f"coordinator state in {directory} is for table_sizes="
                f"{state.get('table_sizes')} but the caller's spec has "
                f"table_sizes={list(spec.table_sizes)}")
        state_n = int(state.get("n_shards", spec.n_shards))
        if state.get("boundaries") is not None:
            # adopt the fleet's stamped layout epoch wholesale: a resize
            # since this standby was configured changed the boundaries,
            # and the takeover must reconcile under the layout the fleet
            # actually runs — not the standby's stale construction spec
            spec = EmbShardSpec(spec.table_sizes, state_n,
                                boundaries=state["boundaries"])
        elif state_n != spec.n_shards:
            raise ValueError(
                f"coordinator state in {directory} is for n_shards="
                f"{state_n} but the caller's spec has n_shards="
                f"{spec.n_shards} (and the legacy record carries no "
                f"boundaries to adopt)")
        if backend is None:
            backend = state.get("backend", "inproc")
        fallback = None
        if addresses is None:
            recorded = state.get("addresses")
            if recorded and any(a is not None for a in recorded):
                # per-shard: a shard whose address was never recorded
                # (its endpoint never connected) auto-spawns a loopback
                # server; the others re-attach to their live writers.
                # Recorded LOOPBACK servers were owned by (and died with)
                # the previous coordinator process — if one is gone,
                # degrade that shard to a fresh auto-spawned writer
                # seeded with the stamped image rather than poisoning it.
                # A dead non-loopback (true multi-host) address stays a
                # poison: silently moving a remote writer's persistence
                # onto this host would be surprising.
                addresses = [tuple(a) if a else None for a in recorded]
                fallback = [a is None or
                            a[0] in ("127.0.0.1", "localhost", "::1")
                            for a in addresses]
        return cls(tables, accs, spec, trainer_state=trainer_state,
                   directory=directory, backend=backend,
                   addresses=addresses,
                   _takeover={"state": state, "fallback": fallback}, **kw)

    # --------------------------------------------------------------- disk --
    @classmethod
    def load_latest(cls, directory: str, tables, accs, spec: EmbShardSpec,
                    trainer_state=None) -> "ShardedCheckpointWriter":
        """Reconstruct a consistent cross-shard image from disk.

        The run the atomic ``CURRENT`` pointer designates is the recovery
        root; its manifest chains to prior runs via ``parent``.  Only
        events logged *before* each run's last ``cycle`` stamp are
        replayed — files persisted after the last coordinator fence may
        cover some shards but not others and are ignored.  The replay is
        **cross-epoch**: a chain that spans resharding is replayed by
        re-slicing each event's rows through the layout epoch that was
        active when it was logged (``layout_epoch`` manifest records and
        stamped ``layout`` events), so each global row lands on its
        newest stamped write regardless of which shard id owned it at the
        time; the trainer replica comes from the newest stamped trainer
        event.  Only the FINAL stamped layout must match ``spec`` —
        ``load_latest_auto`` adopts it automatically.  Returns a
        sync-mode in-memory writer holding the image (use ``restore_all``
        / ``restore_shards``).
        """
        chain = manifest_chain(directory, LAYOUT, None)
        if not chain:
            raise FileNotFoundError(
                f"no loadable checkpoint run in {directory} "
                f"(no CURRENT pointer or manifest.json)")
        for _, m in chain:
            if list(m.get("table_sizes", ())) != list(spec.table_sizes):
                raise ValueError(
                    f"manifest in {directory} is for table_sizes="
                    f"{m.get('table_sizes')} but the caller's spec has "
                    f"table_sizes={list(spec.table_sizes)}")
        final_spec, _ = _final_layout(chain)
        if final_spec is not None and not spec.same_layout(final_spec):
            raise ValueError(
                f"manifest in {directory} last stamped a layout with "
                f"n_shards={final_spec.n_shards} but the caller's spec "
                f"has n_shards={spec.n_shards}: older layouts crossed "
                f"by the chain replay transparently, but the FINAL "
                f"layout must match (load_latest_auto adopts it)")
        g_t = [np.array(_host(t)) for t in tables]
        g_a = [np.array(_host(a)) for a in accs]
        trainer, _, _ = _replay_global(chain, g_t, g_a,
                                       trainer_template=trainer_state)
        # seeded with the replayed host image (its init slices are never
        # read: this writer has no directory), so device tables are not
        # copied to the host a second time
        out = cls(g_t, g_a, spec, trainer_state=None, directory=None,
                  async_save=False, delta_saves=False, backend="inproc")
        for j, store in enumerate(out.stores):
            for t, (lo, hi) in enumerate(out.ranges[j]):
                store.image_tables[t][...] = g_t[t][lo:hi]
                store.image_accs[t][...] = g_a[t][lo:hi]
        out.stores[0].trainer_image = trainer
        return out


def load_latest_auto(directory: str, tables, accs, spec: EmbShardSpec,
                     trainer_state=None):
    """Dispatch on the manifest layout: sharded fleet vs flat store.  The
    run-versioned ``CURRENT`` pointer (or a legacy top-level manifest) is
    resolved first.  For a sharded fleet whose chain crossed a resize, the
    FINAL stamped layout epoch is **adopted** — the caller's ``spec`` only
    pins the table sizes, not the shard count the fleet last ran with.
    Returns an object exposing ``restore_all`` / ``restore_shards``."""
    from repro_torch.core.checkpoint import CheckpointStore, resolve_run_dir
    run_dir = resolve_run_dir(directory)
    if run_dir is None:
        raise FileNotFoundError(
            f"no loadable checkpoint run in {directory}")
    with open(os.path.join(run_dir, "manifest.json")) as f:
        layout = json.load(f).get("layout")
    if layout == LAYOUT:
        final_spec, _ = _final_layout(manifest_chain(directory, LAYOUT,
                                                     None))
        if (final_spec is not None and
                tuple(final_spec.table_sizes) == tuple(spec.table_sizes)
                and not spec.same_layout(final_spec)):
            spec = final_spec
        return ShardedCheckpointWriter.load_latest(
            directory, tables, accs, spec, trainer_state=trainer_state)
    return CheckpointStore.load_latest(directory, tables, accs, spec,
                                       trainer_state=trainer_state)
