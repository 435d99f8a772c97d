"""CPRManager — the policy engine tying PLS, trackers and the store together.

Modes (paper §5.1 "Strategies"):
  full       — full recovery, optimal interval sqrt(2·O_save·T_fail)   (Eq.1)
  partial    — naive partial recovery at the full-recovery interval
  cpr        — CPR-vanilla: interval from target PLS, with the benefit
               analysis fallback to full recovery
  cpr-mfu    — cpr + Most-Frequently-Used priority partial saves
  cpr-ssu    — cpr + Sub-Sampled-Used priority partial saves
  cpr-scar   — cpr + SCAR (shadow-copy) priority saves [Qiao et al. 2019]

For the priority modes, the largest tables covering >=99 % of embedding rows
are saved partially: every r·T_save, at most r·N rows, cycling; the
remaining small tables are always fully saved at each T_save boundary.  PLS bookkeeping per shard uses T_save-boundary events only
(partial saves improve restored values — Fig. 12's slope — not PLS itself).

The port of ``repro.core.manager``, on the flat ``CheckpointStore`` (sync,
or ``async_save``; memory or ``directory``) or, with ``sharded_save`` (or
any fleet transport), on the sharded writer fleet.  Trackers live on the
manager's device; selected rows are gathered there.  The flat store gets
host copies of only those rows; the fleet takes the device rows and drops
unchanged ones on the device before any copy (``row_hash`` runs where
the tables lie: the CUDA kernel on the card, its plain version on the
CPU).  ``tracker_backend`` is ``"host"`` or ``"kernel"``; it and
``hash_backend`` accept ``"pallas"`` as an alias of ``"kernel"`` so
reference configs carry over.  ``hash_backend`` selects nothing, and
``report()`` says where the hash ran.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from repro_torch import resolve_device, tree
from repro_torch.core import overhead as oh
from repro_torch.core import trackers as trk
from repro_torch.core.checkpoint import (AsyncCheckpointWriter,
                                         CheckpointStore, EmbShardSpec, _host,
                                         _nbytes, host_copy)
from repro_torch.core.sharded_checkpoint import (ShardedCheckpointWriter,
                                                 ShardSaveError)
from repro_torch.core.transport import normalize_transport

PRIORITY_MODES = ("cpr-mfu", "cpr-ssu", "cpr-scar")
ALL_MODES = ("full", "partial", "cpr") + PRIORITY_MODES


@dataclass
class OverheadLedger:
    """Simulated-hours overhead charges.

    ``save`` is the *modeled* per-bytes O_save charge (Eq. 1/2); the
    ``save_blocked_s`` / ``save_measured`` pair is the *measured*
    overlap-aware cost: wall-clock seconds the training thread actually
    spent blocked inside save events (snapshotting, staging back-pressure,
    fences — for the sync store, the whole save), and the same mapped onto
    simulated hours via the manager's ``wall_time_scale``.  Totals stay on
    the modeled charge so strategy comparisons remain machine-independent.
    """
    save: float = 0.0
    load: float = 0.0
    lost: float = 0.0
    resched: float = 0.0
    save_blocked_s: float = 0.0   # measured wall seconds on the critical path
    save_measured: float = 0.0    # the same, mapped to simulated hours

    @property
    def total(self):
        return self.save + self.load + self.lost + self.resched

    def as_dict(self, T_total=None):
        d = {"save": self.save, "load": self.load, "lost": self.lost,
             "resched": self.resched, "total": self.total,
             "save_blocked_s": self.save_blocked_s,
             "save_measured": self.save_measured}
        if T_total:
            d["fraction"] = self.total / T_total
        return d


class CPRManager:
    def __init__(self, mode: str, sys_params: oh.SystemParams,
                 table_sizes, target_pls: float = 0.1, r: float = 0.125,
                 ssu_period: int = 2, big_table_coverage: float = 0.99,
                 directory: Optional[str] = None, async_save: bool = False,
                 tracker_backend: str = "host", seg_size=512,
                 hash_backend: str = "host",
                 sharded_save: bool = False,
                 delta_saves: Optional[bool] = None,
                 writer_procs: bool = False, readmit: bool = False,
                 transport: Optional[str] = None,
                 shard_addrs: Optional[list] = None,
                 heartbeat_interval: Optional[float] = None,
                 readmit_backoff: float = 0.0,
                 lease_ttl: Optional[float] = None,
                 transport_options: Optional[dict] = None,
                 parity_group_size: int = 0,
                 attach: bool = False, device=None):
        if mode not in ALL_MODES:
            raise ValueError(f"unknown mode {mode!r}")
        if tracker_backend not in ("host", "kernel", "pallas"):
            raise ValueError(f"unknown tracker_backend {tracker_backend!r}")
        if hash_backend not in ("host", "kernel", "pallas"):
            raise ValueError(f"unknown hash_backend {hash_backend!r}")
        self.device = resolve_device(device)
        self.mode = mode
        self.p = sys_params
        self.target_pls = target_pls
        self.r = r
        self.ssu_period = ssu_period
        self.table_sizes = tuple(table_sizes)
        self.spec = EmbShardSpec(table_sizes, sys_params.N_emb)
        self.directory = directory
        self.async_save = async_save
        # sharded_save: one writer + directory per Emb-PS shard behind a
        # coordinator fence (Check-N-Run's decoupled architecture); delta
        # saves (row-hash skip of unchanged rows) default on with it.
        # transport picks the writer fleet's carrier (core/transport.py):
        # "inproc" applier threads, "pipe" per-shard OS processes (a writer
        # crash poisons one shard, never the trainer), or "socket" —
        # writers on other hosts (launch/shard_server.py) joining the
        # same DRAIN/STAMP fence.  writer_procs=True is the legacy alias
        # for transport="pipe".  Any transport but inproc implies
        # sharded_save.  readmit respawns poisoned writers at the next
        # cycle boundary with a fresh-full reseed instead of leaving
        # fail-stop sticky; readmit_backoff throttles crash-looping shards
        # exponentially; heartbeat_interval starts the proactive
        # dead-writer monitor.
        # attach=True: instead of spawning a fresh writer fleet, take over
        # the one the previous coordinator left behind — read the durable
        # COORDINATOR record in `directory`, claim the next epoch, adopt
        # still-running shard_server writers (socket) or respawn from the
        # stamped images (pipe/inproc), and resume fencing exactly at the
        # last stamped cycle (standby-coordinator failover).
        self._transport_explicit = transport is not None or writer_procs
        self.transport = normalize_transport(
            transport if transport is not None
            else ("pipe" if writer_procs else "inproc"))
        self.writer_procs = self.transport != "inproc"
        self.shard_addrs = shard_addrs
        self.heartbeat_interval = heartbeat_interval
        self.readmit_backoff = readmit_backoff
        self.lease_ttl = lease_ttl
        self._resize_thread = None
        self._resize_box = None
        self._resize_ctx = None
        self.transport_options = transport_options
        # parity_group_size > 0 turns on the XOR erasure-coding layer
        # (ECRM): writers carry running parity of their peers' updates so
        # a poisoned shard's *current* image is reconstructed from
        # survivors instead of replayed from its last stamp.  Under
        # cpr-mfu the manager retunes groups once tracker stats identify
        # the hot shards (smaller groups -> stronger protection).
        self.parity_group_size = int(parity_group_size)
        self._parity_tuned = False
        self.attach = attach
        self.sharded_save = sharded_save or self.writer_procs or attach
        # a remote-backed fleet is asynchronous by construction (saves
        # hand off to the transport; fence() is the durability point)
        self.async_save = async_save or self.writer_procs
        self.readmit = readmit
        self.delta_saves = (self.sharded_save if delta_saves is None
                            else delta_saves)
        self.tracker_backend = ("kernel" if tracker_backend == "pallas"
                                else tracker_backend)
        # seg_size 0 or "auto" defers to a measured autotune pass at
        # tracker_init (table shapes are known there); the chosen value
        # replaces it and surfaces in report()["seg_size"].
        self.seg_size = seg_size
        # the delta-save row hash runs where the tables lie: the row_hash
        # kernel on the card, its plain version (the reference's bits) on
        # the CPU; hash_backend is accepted for the reference's configs
        self.hash_backend = ("kernel" if self.device.type == "cuda"
                             else "host")
        # sim-hours per wall-second of blocked save time; the emulator sets
        # this from its measured step rate so save_measured is comparable
        # to the modeled charges.  0 -> only raw seconds are recorded.
        self.wall_time_scale = 0.0

        # ---- interval policy (paper Fig. 5) ----
        self.decision = oh.choose_strategy(sys_params, target_pls)
        if mode in ("full", "partial"):
            self.T_save = self.decision["T_save_full_optimal"]
            self.uses_partial_recovery = mode == "partial"
        else:
            self.uses_partial_recovery = self.decision["use_partial"]
            self.T_save = (self.decision["T_save_partial"]
                           if self.uses_partial_recovery
                           else self.decision["T_save_full_optimal"])
        self.effective_mode = (mode if (self.uses_partial_recovery or
                                        mode == "full") else "full-fallback")

        # ---- priority-save plan ----
        order = np.argsort(self.table_sizes)[::-1]
        total = sum(self.table_sizes)
        self.big_tables: List[int] = []
        cum = 0
        for t in order:
            if cum / total >= big_table_coverage:
                break
            self.big_tables.append(int(t))
            cum += self.table_sizes[t]
        self.small_tables = [t for t in range(len(self.table_sizes))
                             if t not in self.big_tables]
        self.n_subcycles = max(1, int(round(1.0 / r)))

        # ---- runtime state ----
        self.ledger = OverheadLedger()
        self.pls = 0.0
        self.pls_by_shard = np.zeros(sys_params.N_emb)
        self.n_failures = 0
        self.last_cycle_time = np.zeros(sys_params.N_emb)  # per-shard
        self._next_save_idx = 1       # multiples of sub-interval
        self.store = None             # CheckpointStore | ShardedCheckpointWriter
        self.writer = None            # async/sharded front-end (fence/close)
        self.shard_failures: Dict[int, BaseException] = {}  # poisoned shards
        self.samples_seen = 0
        self.samples_at_cycle = np.zeros(sys_params.N_emb)
        self.history = []

    # ----------------------------------------------------------- setup ----
    @property
    def is_priority(self):
        return self.mode in PRIORITY_MODES and self.effective_mode == self.mode

    def tracker_init(self, tables):
        """Device-side tracker state to thread through the train step."""
        if not self.is_priority:
            return {}
        if self.mode == "cpr-mfu":
            state = {t: trk.mfu_init(self.table_sizes[t], self.device)
                     for t in self.big_tables}
            if self.tracker_backend == "kernel":
                if self.seg_size in (0, "auto"):
                    # measured choice on the largest big table's workload
                    from repro_torch.kernels import ops
                    t_big = max(self.big_tables,
                                key=lambda t: self.table_sizes[t])
                    n = self.table_sizes[t_big]
                    rn = max(1, int(self.r * n))
                    seg, k = trk.segmented_k(n, rn)
                    self.seg_size = ops.autotune_seg_size(n, k,
                                                          device=self.device)
                # pre-warm (and, on the card, build) the selection kernel
                # so the first save's blocked time is checkpoint cost
                for t in self.big_tables:
                    rn = max(1, int(self.r * self.table_sizes[t]))
                    trk.mfu_select_segmented(state[t], rn,
                                             seg_size=self.seg_size)
            return state
        if self.mode == "cpr-ssu":
            # per-table seeds: shared eviction streams would drop the same
            # buffer positions in every table
            return {t: trk.ssu_init(max(1, int(self.r * self.table_sizes[t])),
                                    seed=17 + t, device=self.device)
                    for t in self.big_tables}
        if self.mode == "cpr-scar":
            return {t: trk.scar_init(tables[t]) for t in self.big_tables}
        return {}

    def attach_store(self, tables, accs, trainer_state=None):
        if self.writer is not None:           # re-attach: stop the old thread
            self.writer.close()
        if self.sharded_save:
            # the sharded fleet is both the store (image, restores, byte
            # accounting) and the writer (fence/close routing)
            common = dict(
                async_save=self.async_save, delta_saves=self.delta_saves,
                heartbeat_interval=self.heartbeat_interval,
                readmit_backoff=self.readmit_backoff,
                lease_ttl=self.lease_ttl,
                transport_options=self.transport_options,
                parity_group_size=self.parity_group_size)
            self.store = None
            if self.attach and self.directory:
                try:
                    # standby takeover: adopt the predecessor's fleet; the
                    # recorded backend/addresses win unless the caller
                    # explicitly chose a transport
                    self.store = ShardedCheckpointWriter.attach(
                        self.directory, tables, accs, self.spec,
                        trainer_state=trainer_state,
                        backend=(self.transport if self._transport_explicit
                                 else None),
                        addresses=self.shard_addrs, **common)
                    self.transport = self.store.backend
                    self.writer_procs = self.transport != "inproc"
                except FileNotFoundError:
                    pass                # nothing to attach to: fresh fleet
            if self.store is None:
                self.store = ShardedCheckpointWriter(
                    tables, accs, self.spec, trainer_state,
                    directory=self.directory, backend=self.transport,
                    addresses=self.shard_addrs, **common)
            self.writer = self.store
            # a takeover (or a directory whose chain crossed a resize)
            # may have adopted a different stamped layout than the
            # caller configured: follow it on the policy side too
            self.adopt_layout(self.store.spec)
        else:
            self.store = CheckpointStore(tables, accs, self.spec,
                                         trainer_state,
                                         directory=self.directory)
            self.writer = (AsyncCheckpointWriter(self.store)
                           if self.async_save else None)
        self._total_bytes = sum(_nbytes(t) + _nbytes(a)
                                for t, a in zip(tables, accs))
        if trainer_state is not None:
            self._total_bytes += sum(_nbytes(a)
                                     for a in tree.leaves(trainer_state))

    def fence(self):
        """Drain in-flight async saves (no-op for the sync store).

        A poisoned shard in the sharded fleet is fail-stop per shard: the
        coordinator fence still drains/stamps the healthy shards, and the
        error is recorded in ``shard_failures`` (surfaced in ``report()``)
        instead of killing training — the poisoned shard simply recovers
        from its last-good image."""
        self._join_resize()
        if self.writer is not None:
            try:
                self.writer.fence()
            except ShardSaveError as e:
                self.shard_failures.update(e.shard_errors)

    def close(self):
        """Drain and stop the async writer thread (idempotent)."""
        try:
            self._join_resize()
        # lint: allow[exception-hygiene] close() never raises; a resize
        # error is already latched in shard_failures by _join_resize
        except Exception:
            pass                        # close never raises
        if self.writer is not None:
            self.writer.close()

    # ------------------------------------------------------ save policy ----
    @property
    def save_interval(self) -> float:
        """Interval between save *events* (sub-interval for priority modes)."""
        return self.T_save / self.n_subcycles if self.is_priority else self.T_save

    def due_saves(self, t: float):
        """Save-event times in (last_handled, t]."""
        out = []
        while self._next_save_idx * self.save_interval <= t:
            out.append(self._next_save_idx * self.save_interval)
            self._next_save_idx += 1
        return out

    def _select_rows(self, t, tables, tracker_state, pending_indices):
        """Rows of big table ``t`` to save now (int32 tensor on the device)
        and the updated tracker state."""
        n = self.table_sizes[t]
        rn = max(1, int(self.r * n))
        if self.mode == "cpr-mfu":
            if self.tracker_backend == "kernel":
                pend = (None if pending_indices is None
                        else pending_indices.get(t))
                idx, new_counts = trk.mfu_select_segmented(
                    tracker_state[t], rn, indices=pend,
                    seg_size=self.seg_size)
                rows = idx[idx < n]                 # drop padding picks
            else:
                rows, new_counts = trk.mfu_select(tracker_state[t], rn)
            return rows, {**tracker_state, t: new_counts}
        if self.mode == "cpr-ssu":
            ids, reset = trk.ssu_select(tracker_state[t])
            return ids[ids != trk.EMPTY], {**tracker_state, t: reset}
        rows, new_state = trk.scar_select(tracker_state[t], tables[t], rn)
        return rows, {**tracker_state, t: new_state}

    def _rows_for(self, rows, values, acc_values):
        """What a save_rows call takes: the device rows themselves for the
        fleet, private host copies for the flat store."""
        if self.sharded_save:
            return rows, values, acc_values
        return host_copy(rows), host_copy(values), host_copy(acc_values)

    def run_save(self, t_event: float, tables, accs, tracker_state,
                 trainer_state=None, step: int = 0, pending_indices=None):
        """Execute one save event; returns updated tracker_state.

        Charges the modeled O_save cost proportional to bytes written, and
        separately records the *measured* critical-path cost of this event
        (everything the training thread blocked on: tracker selection,
        host snapshots, staging back-pressure and — at T_save boundaries —
        the durability fence).  With ``async_save`` the image/disk apply
        overlaps training, so only the snapshot/fence time lands here.

        ``pending_indices`` (cpr-mfu + kernel backend only) are accessed
        row ids per big table not yet folded into the device counters; the
        fused kernel applies them during selection.
        """
        assert self.store is not None
        t_wall0 = time.perf_counter()
        self._join_resize()         # a background reshard lands here; the
        #                             join wait counts as save-blocked time
        saver = self.writer if self.writer is not None else self.store
        nbytes = 0
        is_boundary = (not self.is_priority) or (
            round(t_event / self.save_interval) % self.n_subcycles == 0)
        if self.is_priority:
            # partial save of big tables by priority: gather the picked
            # rows on the device; the fleet takes them there (its kernel
            # ledger skips unchanged rows before any copy), the flat store
            # gets host copies of only those rows
            for t in self.big_tables:
                rows, tracker_state = self._select_rows(
                    t, tables, tracker_state, pending_indices)
                if rows.numel():
                    r = rows.long()
                    nbytes += saver.save_rows(
                        t, *self._rows_for(rows, tables[t][r],
                                           accs[t][r]), step=step)
            if is_boundary:
                for t in self.small_tables:
                    n = self.table_sizes[t]
                    nbytes += saver.save_rows(
                        t, *self._rows_for(np.arange(n), tables[t],
                                           accs[t]), step=step)
                # priority modes never run save_full, so the trainer replica
                # (bottom/top MLPs) rides along at every cycle boundary —
                # disk-mode recovery must not restore fresh MLPs
                if trainer_state is not None:
                    nbytes += saver.save_trainer(trainer_state, step=step)
        else:
            nbytes += saver.save_full(tables, accs, trainer_state, step=step)
        if is_boundary and self.writer is not None and (
                self.is_priority or (self.sharded_save and self.directory)):
            # a boundary completes a multi-sub-interval priority cycle: drain
            # it before PLS bookkeeping stamps the cycle as the shards'
            # recovery point.  Flat-store non-priority saves never fence
            # here — queue ordering plus the fence in on_failure/report
            # already guarantee restores observe them, so the apply fully
            # overlaps training.  The sharded fleet with a disk directory
            # must fence every boundary regardless: its crash-durability
            # point is the coordinator's cycle stamp, which only a fence
            # writes — without it a crash would lose the whole run's saves.
            self.fence()
        if is_boundary:
            # a poisoned shard's saves were dropped, so its recovery point
            # (and hence its PLS/lost-time accounting) must stay at the last
            # cycle that actually reached its writer.  Only *currently*
            # poisoned shards hold back — a re-admitted shard resumes
            # advancing once its reseed full is stamped.
            ok = np.ones(self.p.N_emb, dtype=bool)
            if self.sharded_save and self.store is not None:
                bad = set(self.store.failed)
            else:
                bad = set(self.shard_failures)
            for j in bad:
                ok[j] = False
            self.last_cycle_time[ok] = t_event
            self.samples_at_cycle[ok] = self.samples_seen
            if self.readmit and self.sharded_save and self.store.failed:
                # cycle boundary: respawn poisoned writers, reseed from
                # last-good, ship a fresh full of their current rows — the
                # next boundary's fence stamps it and the shard's recovery
                # point catches up then
                readmitted = self.store.readmit(tables, accs, trainer_state,
                                                step=step)
                if readmitted:
                    # the reseed fulls are real save traffic: charge the
                    # re-admitted shards' slice of the total bytes (shard
                    # ranges are equal-sized by construction)
                    nbytes += int(self._total_bytes * len(readmitted) /
                                  self.p.N_emb)
                    self.history.append({"t": t_event, "event": "readmit",
                                         "shards": readmitted})
            self._maybe_tune_parity(tracker_state, t_event)
        # bandwidth-proportional modeled save cost (incl. reseed fulls)
        frac = nbytes / max(self._total_bytes, 1)
        self.ledger.save += self.p.O_save * frac
        # measured overlap-aware critical-path cost — everything the
        # training thread blocked on in this event, re-admission
        # respawn/reseed work included
        blocked = time.perf_counter() - t_wall0
        self.ledger.save_blocked_s += blocked
        self.ledger.save_measured += blocked * self.wall_time_scale
        self.history.append({"t": t_event, "event": "save",
                             "boundary": bool(is_boundary)})
        return tracker_state

    def _maybe_tune_parity(self, tracker_state, t_event):
        """One-shot MFU→parity policy pass (ROADMAP item 1 stretch).

        Once the cpr-mfu tracker counters have observed real traffic,
        rank shards by the hot-row mass that lands in their row ranges
        and hand the hottest ones to ``configure_parity`` — the store
        carves them into half-size (stronger) parity groups.  Runs at
        most once per manager; a fleet resize drops the hot tuning and
        the next boundary with live counters re-applies it.
        """
        if (self.mode != "cpr-mfu" or not tracker_state
                or not (self.sharded_save and self.store is not None)
                or not getattr(self.store, "parity_enabled", False)):
            return
        if self._parity_tuned:
            return
        mass = np.zeros(self.p.N_emb)
        seen = False
        for t, counts in tracker_state.items():
            n = self.table_sizes[t]
            c = _host(counts).astype(np.float64).ravel()[:n]
            if c.size != n or not c.any():
                continue            # pallas padding mismatch / no traffic
            seen = True
            shards = self.spec.shard_of_rows(t, np.arange(n))
            np.add.at(mass, shards, c)
        if not seen:
            return                  # counters still cold: retry next boundary
        hot = [int(j) for j in np.nonzero(mass > mass.mean())[0]]
        if 0 < len(hot) < self.p.N_emb:
            info = self.store.configure_parity(hot_shards=hot)
            self.history.append({"t": t_event, "event": "parity-tune",
                                 "hot_shards": hot, **info})
        self._parity_tuned = True

    # ----------------------------------------------------------- resize ----
    def resize(self, n_shards: int, t_event: Optional[float] = None,
               step: int = 0, background: bool = False) -> Optional[dict]:
        """Online fleet split/merge (``ShardedCheckpointWriter.resize``)
        plus the policy-side re-base: per-shard PLS mass is remapped by
        fractional range overlap between the old and new layouts, every
        recovery point jumps to the reshard stamp (the resize fences a
        fresh full of every shard into the same atomic cycle), and
        ``SystemParams`` adopts the new ``N_emb`` so PLS Eq. 3 divides by
        the live shard count from here on.

        With ``background=True`` the fleet reshard runs on a helper
        thread while the trainer keeps stepping; the manager joins it at
        its next store access (at most one cycle boundary away), applies
        the policy re-base then, and records the trainer-blocked join
        time in the history event.  Returns None immediately in that
        mode — the info dict lands in ``reshard_history``/``history``."""
        if not (self.sharded_save and self.store is not None):
            raise RuntimeError(
                "resize requires sharded_save and an attached store")
        self._join_resize()             # one reshard in flight at a time
        old_n = self.p.N_emb
        if background:
            box = {}

            def work():
                try:
                    # non-blocking writer resize: the seed fulls persist
                    # on the appliers and the layout stamps at the next
                    # boundary fence (which the joining store access runs)
                    box["info"] = self.store.resize(int(n_shards),
                                                    step=step, block=False)
                except BaseException as e:     # surfaced at the join
                    box["err"] = e
            th = threading.Thread(target=work, name="cpr-resize",
                                  daemon=True)
            self._resize_thread = th
            self._resize_box = box
            self._resize_ctx = (old_n, t_event)
            th.start()
            return None
        info = self.store.resize(int(n_shards), step=step)
        return self._apply_resize(info, old_n, t_event,
                                  blocked_s=info["pause_s"])

    def _join_resize(self):
        """Join a background reshard (no-op when none is in flight) and
        apply the deferred policy re-base.  Every manager entry point that
        touches the store calls this first, so the trainer only ever
        blocks here — the 'at most one cycle boundary' pause."""
        th = self._resize_thread
        if th is None:
            return None
        t0 = time.perf_counter()
        th.join()
        blocked = time.perf_counter() - t0
        box, ctx = self._resize_box, self._resize_ctx
        self._resize_thread = self._resize_box = self._resize_ctx = None
        if "err" in box:
            raise box["err"]
        old_n, t_event = ctx
        return self._apply_resize(box["info"], old_n, t_event,
                                  blocked_s=blocked)

    def _apply_resize(self, info, old_n, t_event, blocked_s):
        n_shards = int(info["to"])
        info = dict(info, trainer_blocked_s=blocked_s)
        # the reshard stamped a full of EVERY shard: all recovery points
        # advance to the reshard event
        t_now = (t_event if t_event is not None
                 else float(np.max(self.last_cycle_time)))
        self._rebase_layout(self.store.spec, old_n, n_shards, t_now)
        self.history.append({"t": t_now, "event": "resize", **info})
        return info

    def adopt_layout(self, spec) -> None:
        """Re-base the manager's policy state onto a layout adopted from
        disk (resume via ``load_latest_auto``) or from a fleet takeover
        (``attach``) whose chain crossed a resize: the shard count, PLS
        mass, and per-shard recovery points move to the new boundaries
        exactly as a live resize would re-base them.  No-op when ``spec``
        already matches."""
        if self.spec.same_layout(spec):
            return
        self._rebase_layout(spec, self.p.N_emb, int(spec.n_shards),
                            float(np.max(self.last_cycle_time)))

    def _rebase_layout(self, spec, old_n, n_new, t_now):
        import dataclasses
        self.spec = spec
        self.p = dataclasses.replace(self.p, N_emb=n_new)
        # PLS mass remap: each new shard inherits every old shard's
        # accumulated loss in proportion to their fractional row-range
        # overlap, so total PLS is conserved across the reshard
        ob = np.arange(old_n + 1) / old_n
        nb = np.arange(n_new + 1) / n_new
        new_pls = np.zeros(n_new)
        for j in range(n_new):
            for m in range(old_n):
                ov = min(nb[j + 1], ob[m + 1]) - max(nb[j], ob[m])
                if ov > 0:
                    new_pls[j] += (self.pls_by_shard[m] * ov /
                                   (ob[m + 1] - ob[m]))
        self.pls_by_shard = new_pls
        self.last_cycle_time = np.full(n_new, t_now)
        self.samples_at_cycle = np.full(n_new, float(self.samples_seen))
        # a resize rebuilt the parity groups without the hot-shard tuning
        # (row ranges moved); let the next boundary's policy pass re-rank
        self._parity_tuned = False

    # --------------------------------------------------------- failures ----
    def on_failure(self, event, tables, accs):
        """Apply a failure.  Returns (tables, accs, info).  For full recovery
        the emulator exploits replay-determinism: state is *not* mutated, only
        time is charged (reverting and re-running the same data reproduces the
        exact pre-failure state, paper §5.1).  Partial recovery restores the
        failed shards' rows into ``tables``/``accs`` in place."""
        self._join_resize()         # restores need the post-reshard layout
        self.n_failures += 1
        t = event.time
        info = {"time": t, "shards": event.shard_ids, "mode": self.effective_mode}
        if self.effective_mode in ("full", "full-fallback"):
            last_save = float(np.max(self.last_cycle_time))
            lost = max(0.0, t - last_save)
            self.ledger.load += self.p.O_load
            self.ledger.lost += lost
            self.ledger.resched += self.p.O_res
            info["lost_time"] = lost
            self.history.append({"t": t, "event": "failure", **info})
            return tables, accs, info
        # ---- partial recovery ----
        self.fence()   # restores must observe every enqueued save
        # failure events may predate a resize (the injector samples shard
        # ids against the fleet size at schedule time): fold them onto
        # the live layout
        shard_ids = sorted({int(j) % self.p.N_emb for j in event.shard_ids})
        info["shards"] = shard_ids
        tables, accs = self.store.restore_shards(tables, accs, shard_ids)
        self.ledger.load += self.p.O_load_partial
        self.ledger.resched += self.p.O_res_partial
        # PLS increment (Eq. 3): per failed shard, samples since its last
        # checkpoint cycle / (S_total · N_emb)
        for j in shard_ids:
            inc = (self.samples_seen - self.samples_at_cycle[j]) / \
                max(self._s_total, 1) / self.p.N_emb
            self.pls += inc
            self.pls_by_shard[j] += inc
            # the restored shard is now at its checkpoint state
            self.last_cycle_time[j] = t
            self.samples_at_cycle[j] = self.samples_seen
        info["pls"] = self.pls
        self.history.append({"t": t, "event": "failure", **info})
        return tables, accs, info

    def set_total_samples(self, s_total: int):
        self._s_total = s_total

    # ----------------------------------------------------------- report ----
    def report(self):
        self.fence()   # bytes_written must include in-flight saves
        out = {
            "mode": self.mode,
            "effective_mode": self.effective_mode,
            "async_save": self.async_save,
            "sharded_save": self.sharded_save,
            "writer_backend": self.transport,
            "tracker_backend": self.tracker_backend,
            "hash_backend": self.hash_backend,
            "seg_size": self.seg_size,
            "T_save": self.T_save,
            "save_interval": self.save_interval,
            "target_pls": self.target_pls,
            "expected_pls": (oh.expected_pls(self.p, self.T_save)
                             if self.uses_partial_recovery else 0.0),
            "measured_pls": self.pls,
            "pls_by_shard": self.pls_by_shard.tolist(),
            "n_failures": self.n_failures,
            "overheads": self.ledger.as_dict(self.p.T_total),
            "bytes_written": self.store.bytes_written if self.store else 0,
            "decision": self.decision,
        }
        if self.sharded_save and self.store is not None:
            out["shard_bytes"] = self.store.shard_bytes
            out["shard_events"] = self.store.shard_events
            out["delta_rows_skipped"] = self.store.delta_rows_skipped
            out["delta_bytes_skipped"] = self.store.delta_bytes_skipped
            out["dropped_bytes"] = self.store.dropped_bytes
            # shard_failures is the historical record; poisoned_shards the
            # shards still out of the fleet (empty again after re-admission)
            out["shard_failures"] = sorted(self.shard_failures)
            out["poisoned_shards"] = sorted(self.store.failed)
            out["shard_readmissions"] = self.store.shard_readmissions
            out["coordinator_epoch"] = self.store.epoch
            if getattr(self.store, "parity_enabled", False):
                out["parity"] = self.store.parity_report
            out["layout_epoch"] = self.store.layout_epoch
            if self.store.reshard_history:
                out["reshard_history"] = list(self.store.reshard_history)
            if self.store.attach_report is not None:
                out["attach"] = self.store.attach_report
            wire = self.store.wire_stats
            if wire is not None:
                out["wire"] = wire
        return out
