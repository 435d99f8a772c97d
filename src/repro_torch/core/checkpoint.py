"""Sharded checkpoint store with partial (row-level) saves and restores.

The unit of failure/recovery is an **Emb PS shard**: shard ``j`` of
``n_shards`` owns the contiguous row range ``[floor(j·n/N), floor((j+1)·n/N))``
of every embedding table, together with the matching rows of the optimizer
state (row-wise Adagrad accumulators) — restoring parameters without their
optimizer state would corrupt adaptive-step training.

The store maintains the "on-disk image": what a recovering shard would read
back.  Backends:
  * memory — image held as numpy arrays (fast emulation),
  * disk   — every save event additionally persisted as .npz under
             ``dir/shard_<j>/``, with a JSON manifest; ``load_latest``
             reconstructs the image from disk (crash-durable path used by
             the example drivers and tests).

Disk-format invariants (each fixes a durability bug):
  * every persisted file is keyed by a monotonically increasing event
    sequence number (``partial_t<t>_e<seq>.npz`` / ``full_e<seq>.npz``),
    never by (table, step) — two saves of the same table within one
    training step must not overwrite each other on disk;
  * ``load_latest`` replays strictly in manifest event order from the last
    full event onward — a partial persisted *before* a full at the same
    step must not be re-applied over the newer full image;
  * full checkpoints persist the trainer replica tree (bottom/top MLPs)
    alongside shard 0, and ``load_latest`` restores it;
  * directories are **run-versioned**: every run writes only under its own
    ``run-<n>/`` subdirectory (manifest rewrites are atomic temp+rename)
    and the root's atomic ``CURRENT`` pointer advances at the run's first
    durable event — a new run that crashes early can never corrupt the
    previous run's manifest, and recovery chains back through the
    manifests' ``parent`` links (see docs/recovery.md).

The port of ``repro.core.checkpoint`` (the flat store; the sharded
writer fleet comes with a later slice).  Images stay host numpy arrays,
as in the reference, and the on-disk layout is the reference's byte for
byte, so either side loads a run directory the other wrote.  Inputs may
be torch tensors on any device or numpy arrays; every host snapshot is a
private copy (``host_copy``): ``cpu_tensor.numpy()`` would alias the live
tensor.  ``restore_shards`` writes into the caller's tensors in place.

``AsyncCheckpointWriter`` wraps a store with a background writer thread and
double-buffered snapshot staging, so save calls only pay for the host-side
snapshot copy (the image/disk apply overlaps training) — the Check-N-Run
style decoupling.  ``fence()`` drains in-flight saves; callers must fence
before reading the image (restores, byte audits).

Byte accounting feeds the emulator's save-overhead model.
"""
from __future__ import annotations

import json
import os
import queue
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import tree

class EmbShardSpec:
    """Row-range partitioning of each table over n_shards virtual Emb PS.

    A spec is one **layout**: the boundaries default to the paper's
    even-split formula ``floor(j·n/N)``, but may be overridden (e.g. when
    rebuilding the layout a manifest epoch recorded) — two specs with the
    same boundaries are interchangeable regardless of how they were built.
    """

    def __init__(self, table_sizes: Sequence[int], n_shards: int,
                 boundaries=None):
        self.table_sizes = tuple(table_sizes)
        self.n_shards = n_shards
        # boundaries[t] = array of n_shards+1 row offsets
        if boundaries is None:
            self.boundaries = [
                np.floor(np.arange(n_shards + 1) * n / n_shards)
                .astype(np.int64)
                for n in self.table_sizes
            ]
        else:
            self.boundaries = [np.asarray(b, dtype=np.int64)
                               for b in boundaries]
            if len(self.boundaries) != len(self.table_sizes):
                raise ValueError("boundaries/table_sizes length mismatch")
            for b, n in zip(self.boundaries, self.table_sizes):
                if (b.shape != (n_shards + 1,) or b[0] != 0 or b[-1] != n
                        or np.any(np.diff(b) < 0)):
                    raise ValueError(
                        f"invalid shard boundaries {b.tolist()} for table of "
                        f"{n} rows over {n_shards} shards")

    def shard_range(self, table: int, shard: int):
        b = self.boundaries[table]
        return int(b[shard]), int(b[shard + 1])

    def shard_of_rows(self, table: int, rows: np.ndarray) -> np.ndarray:
        return np.searchsorted(self.boundaries[table], rows, side="right") - 1

    def same_layout(self, other: "EmbShardSpec") -> bool:
        return (self.table_sizes == other.table_sizes
                and self.n_shards == other.n_shards
                and all(np.array_equal(a, b) for a, b in
                        zip(self.boundaries, other.boundaries)))

    def to_json(self) -> dict:
        """JSON-serializable layout record (manifest / coordinator state)."""
        return {"n_shards": self.n_shards,
                "boundaries": [b.tolist() for b in self.boundaries]}

    @classmethod
    def from_json(cls, table_sizes: Sequence[int],
                  obj: dict) -> "EmbShardSpec":
        return cls(table_sizes, int(obj["n_shards"]),
                   boundaries=obj.get("boundaries"))


# flat-store manifest layout tag; "v2" = event-seq-keyed filenames,
# manifest-order replay, trainer persist (the sharded fleet uses its own
# "sharded-v1" tag — see repro.core.sharded_checkpoint)
STORE_LAYOUT = "store-v2"

# run-versioned directory layout: every run writes under its own
# ``run-<n>/`` subdirectory and the root holds one atomic ``CURRENT``
# pointer naming the newest run that reached a durable point.  A new run
# therefore never rewrites the previous run's manifest or files in place —
# a crash before the new run's first durable event/fence leaves CURRENT
# (and everything it references) exactly as the previous run stamped it.
CURRENT_PTR = "CURRENT"


def host_copy(a) -> np.ndarray:
    """Host snapshot that the caller cannot mutate afterwards: a CUDA
    tensor's ``.cpu()`` is already a private copy; a CPU tensor's
    ``.numpy()`` and a numpy array alias, so they are copied."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return a.cpu().numpy() if a.is_cuda else a.numpy().copy()
    return np.array(a)



def _host(a) -> np.ndarray:
    """Numpy view of ``a`` for reading (a copy only for device tensors)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _nbytes(a) -> int:
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    return np.asarray(a).nbytes


def _copy_into(dst: np.ndarray, src) -> None:
    """``dst[...] = src`` straight from a tensor's memory (one device-to-
    host copy for a CUDA tensor, no staging array)."""
    if isinstance(src, torch.Tensor):
        torch.from_numpy(dst).copy_(src.detach())
    else:
        dst[...] = np.asarray(src)


def _write_rows(dst, lo: int, hi: int, image: np.ndarray) -> None:
    """``dst[lo:hi] = image[lo:hi]`` in place, for a tensor or an array."""
    if isinstance(dst, torch.Tensor):
        dst[lo:hi].copy_(torch.from_numpy(image[lo:hi]))
    else:
        dst[lo:hi] = image[lo:hi]


def _read_manifest(directory: str, layout: str,
                   spec: Optional["EmbShardSpec"]):
    """Read + validate ``directory``'s manifest against ``layout`` and the
    caller's shard spec; returns None when no manifest exists.  A layout or
    spec mismatch is an error — replaying another layout's (or another
    N_emb's) files would scatter rows to wrong offsets.

    ``spec=None`` skips the shard-layout check: callers that replay an
    event chain crossing **layout epochs** (``sharded-v1`` manifests with
    resize events) resolve the per-epoch boundaries themselves and validate
    only the chain's *final* layout against the live spec."""
    path = os.path.join(directory, "manifest.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        manifest = json.load(f)
    if manifest.get("layout") != layout:
        raise ValueError(
            f"unsupported checkpoint layout {manifest.get('layout')!r} in "
            f"{directory} (expected {layout!r}; pre-v2 checkpoints used "
            f"step-keyed filenames and must be re-created)")
    if spec is None:
        return manifest
    if (manifest["n_shards"] != spec.n_shards or
            list(manifest["table_sizes"]) != list(spec.table_sizes)):
        raise ValueError(
            f"checkpoint in {directory} was written for n_shards="
            f"{manifest['n_shards']}, table_sizes={manifest['table_sizes']} "
            f"but the caller's spec has n_shards={spec.n_shards}, "
            f"table_sizes={list(spec.table_sizes)}")
    return manifest


def atomic_write_text(path: str, text: str) -> None:
    """Durable atomic file replace: write a temp file, flush + fsync its
    data, rename over ``path``, then fsync the directory so the rename
    itself survives power loss.  Readers always observe either the old
    file or the complete new one, never a torn write."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def atomic_json_dump(path: str, obj) -> None:
    atomic_write_text(path, json.dumps(obj))


def resolve_run_dir(directory: str) -> Optional[str]:
    """The run directory the atomic ``CURRENT`` pointer designates.

    Falls back to ``directory`` itself when it holds a legacy top-level
    ``manifest.json`` (pre-run-versioned layout); returns None when the
    directory holds no loadable run at all — e.g. a brand-new directory, or
    one where a run crashed before its first durable point ever advanced
    CURRENT."""
    cur = os.path.join(directory, CURRENT_PTR)
    if os.path.exists(cur):
        with open(cur) as f:
            name = f.read().strip()
        return os.path.join(directory, name)
    if os.path.exists(os.path.join(directory, "manifest.json")):
        return directory
    return None


def _write_current(directory: str, run_name: str):
    """Atomically advance the CURRENT pointer: readers always observe
    either the old run or the new one, never a torn write."""
    atomic_write_text(os.path.join(directory, CURRENT_PTR), run_name)


def _new_run_dir(directory: str):
    """Allocate the next ``run-<n>/`` under ``directory``.

    Returns ``(path, name, parent)`` where ``parent`` is the run CURRENT
    designated at allocation time (``"run-<m>"``, ``"."`` for a legacy
    top-level manifest, or None for a fresh directory) — recorded in the
    new run's manifest so recovery can chain back through prior runs."""
    os.makedirs(directory, exist_ok=True)
    ns = []
    for d in os.listdir(directory):
        tail = d.split("-", 1)
        if d.startswith("run-") and len(tail) == 2 and tail[1].isdigit():
            ns.append(int(tail[1]))
    name = f"run-{max(ns, default=0) + 1}"
    parent_dir = resolve_run_dir(directory)
    parent = (os.path.relpath(parent_dir, directory)
              if parent_dir is not None else None)
    path = os.path.join(directory, name)
    os.makedirs(path, exist_ok=True)
    return path, name, parent


def manifest_chain(directory: str, layout: str, spec: "EmbShardSpec"):
    """``[(run_dir, manifest), ...]`` from the root-most ancestor run to the
    run CURRENT points at (oldest first).  Empty when the directory holds no
    loadable run."""
    run_dir = resolve_run_dir(directory)
    chain, seen = [], set()
    while run_dir is not None and os.path.normpath(run_dir) not in seen:
        seen.add(os.path.normpath(run_dir))
        m = _read_manifest(run_dir, layout, spec)
        if m is None:
            break
        chain.append((run_dir, m))
        parent = m.get("parent")
        run_dir = (os.path.normpath(os.path.join(directory, parent))
                   if parent else None)
    chain.reverse()
    return chain


class CheckpointStore:
    def __init__(self, tables: List[np.ndarray], accs: List[np.ndarray],
                 spec: EmbShardSpec, trainer_state=None,
                 directory: Optional[str] = None):
        self.spec = spec
        # the on-disk image starts as the initial state (a cold row that was
        # never saved restores to its initial value, which is also what a
        # fresh shard would re-initialize to)
        self.image_tables = [host_copy(t) for t in tables]
        self.image_accs = [host_copy(a) for a in accs]
        self.trainer_image = _to_numpy(trainer_state)
        self.root_dir = directory
        self.directory = directory
        self.bytes_written = 0
        self.save_events = 0
        self.last_full_save_step = -1
        self._seq = 0   # monotonically increasing event sequence number
        if directory:
            # run-versioned layout: this run writes only under its own
            # run-<n>/ and chains to the prior run via the manifest's
            # ``parent`` field instead of rewriting anything in place.  The
            # CURRENT pointer advances at our first durably logged event, so
            # a crash before then leaves the previous run fully loadable.
            chain = manifest_chain(directory, STORE_LAYOUT, spec)
            self._seq = max((e.get("seq", 0) for _, m in chain
                             for e in m["events"]), default=0)
            run_dir, run_name, parent = _new_run_dir(directory)
            self.directory = run_dir
            self.run_name = run_name
            self._current_advanced = False
            self._manifest = {"layout": STORE_LAYOUT, "run": run_name,
                              "parent": parent, "events": [],
                              "n_shards": spec.n_shards,
                              "table_sizes": list(spec.table_sizes)}

    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    # ------------------------------------------------------------ saves ----
    def save_full(self, tables, accs, trainer_state=None, step: int = 0):
        """Full checkpoint of every shard (and the trainer replica)."""
        nbytes = 0
        for t, (src, acc) in enumerate(zip(tables, accs)):
            _copy_into(self.image_tables[t], src)
            _copy_into(self.image_accs[t], acc)
            nbytes += _nbytes(src) + _nbytes(acc)
        if trainer_state is not None:
            self.trainer_image = _to_numpy(trainer_state)
            nbytes += sum(a.nbytes for a in _leaves(self.trainer_image))
        self.bytes_written += nbytes
        self.save_events += 1
        self.last_full_save_step = step
        if self.directory:
            seq = self._next_seq()
            for j in range(self.spec.n_shards):
                self._persist_shard(j, seq, kind="full")
            ev = {"kind": "full", "step": step, "seq": seq, "bytes": nbytes}
            if trainer_state is not None:
                # the trainer replica (bottom/top MLPs) travels with the
                # full: disk-mode full recovery must not restore fresh MLPs
                ev["trainer_file"] = self._persist_trainer(seq)
            self._log_event(ev)
        return nbytes

    def save_trainer(self, trainer_state, step: int = 0):
        """Persist/refresh the trainer replica image on its own (priority
        modes never call ``save_full``, yet disk recovery still needs the
        bottom/top MLPs — the manager ships them at T_save boundaries)."""
        if trainer_state is None:
            return 0
        self.trainer_image = _to_numpy(trainer_state)
        nbytes = sum(a.nbytes for a in _leaves(self.trainer_image))
        self.bytes_written += nbytes
        self.save_events += 1
        if self.directory:
            seq = self._next_seq()
            self._log_event({"kind": "trainer", "step": step, "seq": seq,
                             "bytes": nbytes,
                             "trainer_file": self._persist_trainer(seq)})
        return nbytes

    def _filter_rows(self, table: int, rows, values, acc_values):
        """Drop row ids outside the table (shared with the async writer so
        byte accounting stays in lockstep across both paths)."""
        rows = _host(rows)
        valid = (rows >= 0) & (rows < self.spec.table_sizes[table])
        return (rows[valid], _host(values)[valid], _host(acc_values)[valid])

    def save_rows(self, table: int, rows: np.ndarray, values: np.ndarray,
                  acc_values: np.ndarray, step: int = 0):
        """Partial (priority) save of selected rows of one table."""
        rows, values, acc_values = self._filter_rows(table, rows, values,
                                                     acc_values)
        if rows.size == 0:
            return 0
        self.image_tables[table][rows] = values
        self.image_accs[table][rows] = acc_values
        nbytes = values.nbytes + acc_values.nbytes + rows.nbytes
        self.bytes_written += nbytes
        self.save_events += 1
        if self.directory:
            # keyed by event seq, not (table, step): two sub-interval saves
            # of the same table in one training step must land in distinct
            # files, else the manifest replays both events from whichever
            # file survived the overwrite
            seq = self._next_seq()
            fname = f"partial_t{table}_e{seq}.npz"
            np.savez_compressed(os.path.join(self.directory, fname),
                                rows=rows, values=values,
                                accs=acc_values, table=table, step=step)
            self._log_event({"kind": "partial", "table": table, "step": step,
                             "seq": seq, "bytes": nbytes, "file": fname})
        return nbytes

    # --------------------------------------------------------- restores ----
    def restore_shards(self, tables, accs, shard_ids: Sequence[int]):
        """Partial recovery: revert only the failed shards' row ranges.

        Unlike the reference, which returns new numpy copies, this writes
        the image rows into the caller's tensors (or arrays) **in place**
        and returns the same lists: at full Criteo width a copy of every
        table per failure would be 2.3 GB of traffic for nothing."""
        for t in range(len(tables)):
            for j in shard_ids:
                lo, hi = self.spec.shard_range(t, j)
                if hi > lo:
                    _write_rows(tables[t], lo, hi, self.image_tables[t])
                    _write_rows(accs[t], lo, hi, self.image_accs[t])
        return tables, accs

    def restore_all(self):
        """Full recovery image (every shard + trainer)."""
        return ([t.copy() for t in self.image_tables],
                [a.copy() for a in self.image_accs],
                self.trainer_image)

    # ------------------------------------------------------------- disk ----
    def _persist_shard(self, shard: int, seq: int, kind: str):
        d = os.path.join(self.directory, f"shard_{shard}")
        os.makedirs(d, exist_ok=True)
        arrs = {}
        for t in range(len(self.image_tables)):
            lo, hi = self.spec.shard_range(t, shard)
            arrs[f"table_{t}"] = self.image_tables[t][lo:hi]
            arrs[f"acc_{t}"] = self.image_accs[t][lo:hi]
        np.savez_compressed(os.path.join(d, f"{kind}_e{seq}.npz"), **arrs)

    def _persist_trainer(self, seq: int) -> str:
        """Persist the trainer replica tree alongside shard 0."""
        d = os.path.join(self.directory, "shard_0")
        os.makedirs(d, exist_ok=True)
        fname = f"trainer_e{seq}.npz"
        save_trainer_tree(os.path.join(d, fname), self.trainer_image)
        return fname

    def _log_event(self, ev):
        ev["time"] = time.time()
        self._manifest["events"].append(ev)
        # atomic durable rewrite: a crash — or power loss — mid-write must
        # never leave a torn manifest.json (the pre-run-versioned in-place
        # rewrite bug)
        atomic_json_dump(os.path.join(self.directory, "manifest.json"),
                         self._manifest)
        if not self._current_advanced:
            # first durable event of this run: only now may recovery prefer
            # this run over its parent
            _write_current(self.root_dir, self.run_name)
            self._current_advanced = True

    @classmethod
    def load_latest(cls, directory: str, tables, accs, spec: EmbShardSpec,
                    trainer_state=None):
        """Reconstruct the image from disk.

        Replays strictly in **manifest event order**: the last full event is
        the base image, and only partial events logged *after* it are
        re-applied — a partial persisted before the full at the same step is
        already folded into (or superseded by) the full image and must not
        resurface over it.  With the run-versioned layout the event log is
        the concatenation of every ancestor run's manifest (oldest first)
        followed by the run CURRENT points at; each event's files are read
        from its own run directory.  ``trainer_state`` supplies the tree
        structure the persisted trainer leaves are unflattened into (when
        omitted, the raw leaf list is kept).
        """
        store = cls(tables, accs, spec, directory=None)
        chain = manifest_chain(directory, STORE_LAYOUT, spec)
        if not chain:
            raise FileNotFoundError(
                f"no loadable checkpoint run in {directory} "
                f"(no CURRENT pointer or manifest.json)")
        events = [(run_dir, e) for run_dir, m in chain
                  for e in m["events"]]
        full_idx = None
        for i, (_, e) in enumerate(events):
            if e["kind"] == "full":
                full_idx = i
        start = 0
        if full_idx is not None:
            run_dir, e = events[full_idx]
            for j in range(spec.n_shards):
                path = os.path.join(run_dir, f"shard_{j}",
                                    f"full_e{e['seq']}.npz")
                with np.load(path) as z:
                    for t in range(len(tables)):
                        lo, hi = spec.shard_range(t, j)
                        store.image_tables[t][lo:hi] = z[f"table_{t}"]
                        store.image_accs[t][lo:hi] = z[f"acc_{t}"]
            start = full_idx + 1
        for run_dir, e in events[start:]:
            if e["kind"] == "partial":
                with np.load(os.path.join(run_dir, e["file"])) as z:
                    t = int(z["table"])
                    store.image_tables[t][z["rows"]] = z["values"]
                    store.image_accs[t][z["rows"]] = z["accs"]
        # trainer replica: every trainer-bearing event (full or standalone)
        # carries the complete tree, so the last one logged wins
        tr_ev = None
        for run_dir, e in events:
            if e.get("trainer_file"):
                tr_ev = (run_dir, e)
        if tr_ev is not None:
            store.trainer_image = load_trainer_tree(
                os.path.join(tr_ev[0], "shard_0", tr_ev[1]["trainer_file"]),
                trainer_state)
        return store


class AsyncApplier:
    """Background apply thread with bounded staging and a fail-stop latch.

    The generic machinery under :class:`AsyncCheckpointWriter`, factored out
    so the per-shard writer fleet (``repro.core.sharded_checkpoint``) can run
    one applier per Emb-PS shard: ``submit`` enqueues ``fn(*args, **kw)`` for
    the worker thread (blocking when ``max_inflight`` snapshots are already
    staged), ``fence`` drains the queue and re-raises any latched worker
    error, and after a worker error every later submission is discarded —
    never applied out of order around the hole.
    """

    def __init__(self, name: str = "cpr-async-ckpt", max_inflight: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max_inflight)
        self._exc: Optional[BaseException] = None
        self._closed = False
        self._thread = threading.Thread(target=self._worker, name=name,
                                        daemon=True)
        self._thread.start()

    @property
    def error(self) -> Optional[BaseException]:
        """The latched worker error, if any (fail-stop: it never clears)."""
        return self._exc

    def _worker(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                if self._exc is None:          # fail-stop: drop after error
                    fn, args, kw = item
                    fn(*args, **kw)
            except BaseException as e:        # latched, re-raised on caller
                self._exc = e
            finally:
                self._q.task_done()

    def submit(self, fn, *args, **kw):
        self._check()
        if self._closed:   # not an assert: under -O a stripped check would
            raise RuntimeError("writer is closed")  # enqueue into a dead
        self._q.put((fn, args, kw))           # thread and deadlock on full

    def _check(self):
        if self._exc is not None:             # stays latched: fail-stop
            raise RuntimeError("async checkpoint writer failed; "
                               "saves after the failure were discarded"
                               ) from self._exc

    def fence(self):
        """Block until every enqueued apply has run (or been discarded)."""
        self._q.join()
        self._check()

    def close(self):
        """Best-effort shutdown; never raises (use fence() to check)."""
        if self._closed:
            return
        self._closed = True
        self._q.put(None)
        self._thread.join()


class AsyncCheckpointWriter(AsyncApplier):
    """Asynchronous front-end for a :class:`CheckpointStore`.

    ``save_full`` / ``save_rows`` take a consistent host snapshot of their
    inputs on the caller thread (the only critical-path work), enqueue it,
    and return the snapshot's byte count immediately; a background thread
    applies the event to the store (image update + optional disk persist)
    in submission order.  Staging is double-buffered: at most
    ``max_inflight`` (default 2) snapshots may be queued, so a third save
    arriving while both buffers are in flight blocks.  That back-pressure
    wait (and any fence) lands inside the caller's save-call wall time,
    which ``CPRManager.run_save`` measures into the overhead ledger as the
    critical-path save cost.

    Consistency contract: ``fence()`` before any image read (restore,
    ``load_latest``, byte audits) observes every previously enqueued save.
    Failures are fail-stop: once a queued apply raises, later queued saves
    are discarded (never applied out of order around the hole) and every
    subsequent ``save_*``/``fence`` re-raises the latched error — the image
    can no longer silently diverge from what the caller believes is saved.
    ``close()`` is best-effort shutdown and does not raise.
    """

    def __init__(self, store: CheckpointStore, max_inflight: int = 2):
        self.store = store
        super().__init__(max_inflight=max_inflight)

    # kept under the historical name: tests poke failure injection through it
    _submit = AsyncApplier.submit

    # ------------------------------------------------------------- saves --
    _snap = staticmethod(host_copy)

    def save_full(self, tables, accs, trainer_state=None, step: int = 0):
        """Snapshot + enqueue a full checkpoint; returns snapshot bytes."""
        snap_t = [self._snap(t) for t in tables]
        snap_a = [self._snap(a) for a in accs]
        snap_tr = None
        if trainer_state is not None:
            snap_tr = tree.tree_map(self._snap, trainer_state)
        nbytes = sum(t.nbytes + a.nbytes for t, a in zip(snap_t, snap_a))
        if snap_tr is not None:
            nbytes += sum(a.nbytes for a in _leaves(snap_tr))
        self._submit(self.store.save_full, snap_t, snap_a, snap_tr, step)
        return nbytes

    def save_rows(self, table: int, rows, values, acc_values, step: int = 0):
        """Snapshot + enqueue a partial save; returns snapshot bytes."""
        # boolean-mask indexing in _filter_rows yields fresh host copies,
        # so the snapshot never aliases caller memory
        rows, values, acc_values = self.store._filter_rows(
            table, rows, values, acc_values)
        if rows.size == 0:
            return 0
        self._submit(self.store.save_rows, table, rows, values, acc_values,
                     step)
        return values.nbytes + acc_values.nbytes + rows.nbytes

    def save_trainer(self, trainer_state, step: int = 0):
        """Snapshot + enqueue a trainer-replica save; returns snapshot bytes."""
        if trainer_state is None:
            return 0
        snap = tree.tree_map(self._snap, trainer_state)
        self._submit(self.store.save_trainer, snap, step)
        return sum(np.asarray(a).nbytes for a in _leaves(snap))


def save_trainer_tree(path: str, tree) -> int:
    """Persist a (numpy) pytree as an .npz of ordered leaves (jax's flatten
    order: dict keys sorted, lists in order); returns bytes."""
    leaves = _leaves(tree)
    np.savez_compressed(path, **{f"leaf_{i}": np.asarray(a)
                                 for i, a in enumerate(leaves)})
    return sum(np.asarray(a).nbytes for a in leaves)


def load_trainer_tree(path: str, template=None):
    """Inverse of :func:`save_trainer_tree`.  ``template`` supplies the tree
    structure (leaf order is jax's canonical flatten order); without it the
    raw leaf list is returned."""
    with np.load(path) as z:
        leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
    if template is None:
        return leaves
    return tree.unflatten(template, leaves)


def _to_numpy(state):
    if state is None:
        return None
    return tree.tree_map(host_copy, state)


def _leaves(state):
    return tree.leaves(state)
