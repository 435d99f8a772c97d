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
remaining small tables are always fully saved at each T_save boundary.  PLS
bookkeeping per shard uses T_save-boundary events only.

The port of ``repro.core.manager`` on the flat ``CheckpointStore`` (sync,
or ``async_save``; memory or ``directory``).  Trackers live on the
manager's device; selected rows are gathered there and only those rows
cross to the host.  ``tracker_backend`` is ``"host"`` (plain PyTorch
selection) or ``"kernel"`` (the ``tracker_select`` / ``ssu_dedupe_evict``
kernels on CUDA); ``"pallas"`` is accepted as an alias of ``"kernel"`` so
reference configs carry over.  The sharded writer fleet's arguments raise
``NotImplementedError`` until the slice that ports it.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from repro_torch import resolve_device, tree
from repro_torch.core import overhead as oh
from repro_torch.core import trackers as trk
from repro_torch.core.checkpoint import (AsyncCheckpointWriter, CheckpointStore,
                                         EmbShardSpec, host_copy)

PRIORITY_MODES = ("cpr-mfu", "cpr-ssu", "cpr-scar")
ALL_MODES = ("full", "partial", "cpr") + PRIORITY_MODES

# sharded writer fleet arguments of the reference and their inert values;
# anything else needs the fleet, which a later slice ports
_FLEET_DEFAULTS = {"sharded_save": False, "delta_saves": None,
                   "writer_procs": False, "readmit": False,
                   "transport": None, "shard_addrs": None,
                   "heartbeat_interval": None, "readmit_backoff": 0.0,
                   "lease_ttl": None, "transport_options": None,
                   "parity_group_size": 0, "attach": False,
                   "hash_backend": "host"}


@dataclass
class OverheadLedger:
    """Simulated-hours overhead charges.

    ``save`` is the *modeled* per-bytes O_save charge (Eq. 1/2); the
    ``save_blocked_s`` / ``save_measured`` pair is the *measured* cost: wall
    seconds the training thread spent blocked inside save events, and the
    same mapped onto simulated hours via the manager's ``wall_time_scale``.
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
                 device=None, **fleet):
        if mode not in ALL_MODES:
            raise ValueError(f"unknown mode {mode!r}")
        if tracker_backend not in ("host", "kernel", "pallas"):
            raise ValueError(f"unknown tracker_backend {tracker_backend!r}")
        for name, value in fleet.items():
            if name not in _FLEET_DEFAULTS:
                raise TypeError(f"unexpected keyword argument {name!r}")
            inert = (value == _FLEET_DEFAULTS[name] or
                     (name == "transport" and value == "inproc"))
            if not inert:
                raise NotImplementedError("slice 2")
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
        self.tracker_backend = ("kernel" if tracker_backend == "pallas"
                                else tracker_backend)
        # seg_size 0 or "auto" defers to a measured autotune pass at
        # tracker_init; the chosen value surfaces in report()["seg_size"]
        self.seg_size = seg_size
        # sim-hours per wall-second of blocked save time (set by the
        # emulator from its measured step rate)
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
        self.store = None             # CheckpointStore
        self.writer = None            # AsyncCheckpointWriter (fence/close)
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
        self.store = CheckpointStore(tables, accs, self.spec, trainer_state,
                                     directory=self.directory)
        self.writer = (AsyncCheckpointWriter(self.store)
                       if self.async_save else None)
        self._total_bytes = sum(a.nbytes for a in self.store.image_tables +
                                self.store.image_accs)
        if trainer_state is not None:
            self._total_bytes += sum(a.nbytes for a in
                                     tree.leaves(self.store.trainer_image))

    def fence(self):
        """Drain in-flight async saves (no-op for the sync store)."""
        if self.writer is not None:
            self.writer.fence()

    def close(self):
        """Drain and stop the async writer thread (idempotent)."""
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

    def run_save(self, t_event: float, tables, accs, tracker_state,
                 trainer_state=None, step: int = 0, pending_indices=None):
        """Execute one save event; returns updated tracker_state.

        Charges the modeled O_save cost proportional to bytes written, and
        separately records the *measured* critical-path cost of this event
        (tracker selection, host snapshots, staging back-pressure and — at
        T_save boundaries — the fence).

        ``pending_indices`` (cpr-mfu + kernel backend only) are accessed
        row ids per big table not yet folded into the counters; the fused
        kernel applies them during selection.
        """
        assert self.store is not None
        t_wall0 = time.perf_counter()
        saver = self.writer if self.writer is not None else self.store
        nbytes = 0
        is_boundary = (not self.is_priority) or (
            round(t_event / self.save_interval) % self.n_subcycles == 0)
        if self.is_priority:
            # partial save of big tables by priority: gather the picked
            # rows on the device, copy only those to the host
            for t in self.big_tables:
                rows, tracker_state = self._select_rows(
                    t, tables, tracker_state, pending_indices)
                if rows.numel():
                    r = rows.long()
                    nbytes += saver.save_rows(
                        t, host_copy(rows), host_copy(tables[t][r]),
                        host_copy(accs[t][r]), step=step)
            if is_boundary:
                for t in self.small_tables:
                    n = self.table_sizes[t]
                    nbytes += saver.save_rows(t, np.arange(n),
                                              host_copy(tables[t]),
                                              host_copy(accs[t]), step=step)
                # priority modes never run save_full, so the trainer replica
                # (bottom/top MLPs) rides along at every cycle boundary
                if trainer_state is not None:
                    nbytes += saver.save_trainer(trainer_state, step=step)
        else:
            nbytes += saver.save_full(tables, accs, trainer_state, step=step)
        if is_boundary and self.writer is not None and self.is_priority:
            # a boundary completes a multi-sub-interval priority cycle: drain
            # it before PLS bookkeeping stamps the cycle as the recovery point
            self.fence()
        if is_boundary:
            self.last_cycle_time[:] = t_event
            self.samples_at_cycle[:] = self.samples_seen
        # bandwidth-proportional modeled save cost
        frac = nbytes / max(self._total_bytes, 1)
        self.ledger.save += self.p.O_save * frac
        blocked = time.perf_counter() - t_wall0
        self.ledger.save_blocked_s += blocked
        self.ledger.save_measured += blocked * self.wall_time_scale
        self.history.append({"t": t_event, "event": "save",
                             "boundary": bool(is_boundary)})
        return tracker_state

    # --------------------------------------------------------- failures ----
    def on_failure(self, event, tables, accs):
        """Apply a failure.  Returns (tables, accs, info).  For full recovery
        the emulator exploits replay-determinism: state is *not* mutated, only
        time is charged.  Partial recovery restores the failed shards' rows
        into ``tables``/``accs`` in place (see ``restore_shards``)."""
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
        return {
            "mode": self.mode,
            "effective_mode": self.effective_mode,
            "async_save": self.async_save,
            "sharded_save": False,
            "writer_backend": "inproc",
            "tracker_backend": self.tracker_backend,
            "hash_backend": "host",
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
