"""Runtime lock-order sanitizer: fail on cycles in acquisition order.

The port's own copy of ``repro.analysis.lockorder``: by default it tracks
the locks that ``repro_torch`` source constructs (sites under
``/repro_torch/``), and none of the reference's.

Static lock-discipline checking (``repro_torch.analysis.rules.locks``) is
lexical; it cannot see the *order* in which threads take locks at run
time.  This module is the dynamic half: ``install()`` monkeypatches
``threading.Lock``/``threading.RLock`` so that every lock constructed
*from repro_torch source code* is wrapped in a tracking proxy.  Each
acquisition while other tracked locks are held records a directed edge
``held-site -> acquired-site`` in a global graph keyed by the lock's
construction site (file:line) — so all per-shard instances of, say,
``RemoteEndpoint._io_lock`` collapse into one node, and an ABBA order
between two lock *classes* is visible even when no single pair of
instances ever deadlocks in the observed run.

A cycle in that graph is a latent deadlock: some interleaving of the
observed threads can block forever.  ``find_cycle()`` returns one, and
``tests/test_torch_lockorder.py`` asserts acyclicity after each of the
port's fleet workloads (failover, reshard, the process transports), so
they double as race-detector workloads.

Notes and limits:

* Re-entrant acquisition of the *same instance* (RLock) adds no edge.
  Two **distinct** instances from the same construction site nested in
  one thread do add a self-edge — same-class nesting is exactly the
  ABBA-by-symmetry hazard.
* Only locks constructed while installed are tracked; locks internal to
  stdlib objects (queues, events) are untracked by the source-file
  filter.
* ``threading.Condition`` constructed from repro_torch source is wrapped in
  :class:`_TrackedCondition`: its underlying lock is tracked like any
  other, and ``wait()`` models the release/reacquire pair — the lock
  leaves the held-stack while blocked and re-records ordering edges on
  wakeup.  Without this, a thread that holds lock A while a *condition*
  reacquires lock B on wakeup would hide an A->B edge (the
  ABBA-via-condition hazard: ``_MuxChan`` inboxes are exactly this
  shape).
"""
from __future__ import annotations

import _thread
import os
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple


class LockOrderError(AssertionError):
    """A cycle exists in the observed lock-acquisition graph."""


class _TrackedLock:
    """Proxy around a real Lock/RLock that reports to the sanitizer."""

    def __init__(self, inner, site: str, san: "LockOrderSanitizer"):
        self._inner = inner
        self.site = site
        self._san = san

    def acquire(self, blocking=True, timeout=-1):
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._san._note_acquire(self)
        return got

    def release(self):
        self._san._note_release(self)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked()

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __repr__(self):
        return f"<tracked {self._inner!r} from {self.site}>"


class _TrackedCondition:
    """Proxy around a real Condition whose lock is a tracked proxy.

    ``wait()`` is the interesting part: the real Condition releases and
    reacquires the underlying lock through private fast paths the
    sanitizer cannot see, so the proxy brackets the real wait with
    explicit release/acquire notes.  While blocked, the lock is off the
    thread's held-stack (true — wait released it); on wakeup the
    reacquisition records ordering edges against everything else the
    thread holds, exactly as a fresh ``acquire()`` would."""

    def __init__(self, inner, lockp: _TrackedLock,
                 san: "LockOrderSanitizer"):
        self._inner = inner             # real Condition over the real lock
        self._lockp = lockp             # tracked proxy over that same lock
        self._san = san
        self.site = lockp.site

    def acquire(self, *args, **kw):
        return self._lockp.acquire(*args, **kw)

    def release(self):
        self._lockp.release()

    def __enter__(self):
        self._lockp.acquire()
        return self

    def __exit__(self, *exc):
        self._lockp.release()
        return False

    def wait(self, timeout=None):
        self._san._note_release(self._lockp)
        try:
            return self._inner.wait(timeout)
        finally:
            self._san._note_acquire(self._lockp)

    def wait_for(self, predicate, timeout=None):
        # stdlib loop, re-expressed over the tracked wait()
        endtime = None
        waittime = timeout
        result = predicate()
        while not result:
            if waittime is not None:
                if endtime is None:
                    endtime = time.monotonic() + waittime
                else:
                    waittime = endtime - time.monotonic()
                    if waittime <= 0:
                        break
            self.wait(waittime)
            result = predicate()
        return result

    def notify(self, n=1):
        self._inner.notify(n)

    def notify_all(self):
        self._inner.notify_all()

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __repr__(self):
        return f"<tracked {self._inner!r} from {self.site}>"


class LockOrderSanitizer:
    """Records per-thread lock nesting; detects acquisition-order cycles.

    ``package`` filters which construction sites get tracked (the frame
    that called ``threading.Lock()`` must live under ``<package>/``);
    pass ``package=None`` to track every construction, or skip
    ``install()`` entirely and wrap locks explicitly with ``wrap()``.
    """

    def __init__(self, package: Optional[str] = "repro_torch"):
        self._package = package
        # (held_site, acquired_site) -> acquiring thread name (first seen)
        self._edges: Dict[Tuple[str, str], str] = {}
        # raw lock: the recorder must never route through a tracked lock
        self._mu = _thread.allocate_lock()
        self._tls = threading.local()
        self._orig = None
        self._orig_cond = None
        self.tracked_constructions = 0

    # -- wrapping -------------------------------------------------------
    def wrap(self, inner, site: str) -> _TrackedLock:
        self.tracked_constructions += 1
        return _TrackedLock(inner, site, self)

    def wrap_condition(self, lock, site: str) -> _TrackedCondition:
        """A tracked Condition: its lock joins the acquisition graph and
        ``wait()``'s release/reacquire pair is modeled (see
        :class:`_TrackedCondition`).  ``lock`` may be None (a fresh
        RLock, stdlib default), an already-tracked lock, or a raw one."""
        real_cond = (self._orig_cond if self._orig_cond is not None
                     else threading.Condition)
        if isinstance(lock, _TrackedLock):
            lockp = lock
        else:
            if lock is None:
                real_rlock = (self._orig[1] if self._orig is not None
                              else threading.RLock)
                lock = real_rlock()
            lockp = self.wrap(lock, site)
        return _TrackedCondition(real_cond(lockp._inner), lockp, self)

    def _site_of(self, frame) -> Optional[str]:
        fn = frame.f_code.co_filename.replace(os.sep, "/")
        if fn.endswith("/analysis/lockorder.py"):
            # a construction relayed through another (stacked) sanitizer's
            # factory: never track our own machinery, and leave the
            # filtering decision to the outermost factory's caller frame
            return None
        if self._package is not None:
            marker = f"/{self._package}/"
            if marker not in fn:
                return None
            fn = fn[fn.rindex(marker) + len(marker):]
        return f"{fn}:{frame.f_lineno}"

    def install(self):
        """Patch threading.Lock/RLock/Condition to return tracked
        objects for constructions originating in ``package`` source
        files."""
        if self._orig is not None:
            return
        real_lock, real_rlock = threading.Lock, threading.RLock
        real_cond = threading.Condition
        self._orig = (real_lock, real_rlock)
        self._orig_cond = real_cond

        def make(real):
            def factory():
                site = self._site_of(sys._getframe(1))
                if site is None:
                    return real()
                return self.wrap(real(), site)
            return factory

        def cond_factory(lock=None):
            site = self._site_of(sys._getframe(1))
            if site is None:
                return real_cond(lock)
            return self.wrap_condition(lock, site)

        threading.Lock = make(real_lock)
        threading.RLock = make(real_rlock)
        threading.Condition = cond_factory

    def uninstall(self):
        if self._orig is None:
            return
        threading.Lock, threading.RLock = self._orig
        threading.Condition = self._orig_cond
        self._orig = None
        self._orig_cond = None

    # -- recording ------------------------------------------------------
    def _held(self) -> List[_TrackedLock]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _note_acquire(self, lock: _TrackedLock):
        stack = self._held()
        if not any(h is lock for h in stack):   # re-entrant: no new edges
            thread = threading.current_thread().name
            with self._mu:
                for held in stack:
                    self._edges.setdefault((held.site, lock.site), thread)
        stack.append(lock)

    def _note_release(self, lock: _TrackedLock):
        stack = self._held()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is lock:
                del stack[i]
                return

    # -- reporting ------------------------------------------------------
    def edges(self) -> Dict[Tuple[str, str], str]:
        with self._mu:
            return dict(self._edges)

    def reset(self):
        with self._mu:
            self._edges.clear()

    def find_cycle(self) -> Optional[List[str]]:
        """One acquisition-order cycle as ``[a, b, ..., a]``, or None."""
        edges = self.edges()
        adj: Dict[str, List[str]] = {}
        for (a, b) in edges:
            adj.setdefault(a, []).append(b)
            adj.setdefault(b, [])
        state: Dict[str, int] = {}      # 0 absent / 1 on path / 2 done
        path: List[str] = []

        def dfs(node: str) -> Optional[List[str]]:
            state[node] = 1
            path.append(node)
            for nxt in adj[node]:
                if state.get(nxt, 0) == 1:
                    return path[path.index(nxt):] + [nxt]
                if state.get(nxt, 0) == 0:
                    cyc = dfs(nxt)
                    if cyc is not None:
                        return cyc
            path.pop()
            state[node] = 2
            return None

        for start in sorted(adj):
            if state.get(start, 0) == 0:
                cyc = dfs(start)
                if cyc is not None:
                    return cyc
        return None

    def assert_acyclic(self):
        cyc = self.find_cycle()
        if cyc is not None:
            edges = self.edges()
            detail = "\n".join(
                f"  {a} -> {b}   (thread {edges.get((a, b), '?')})"
                for a, b in zip(cyc, cyc[1:]))
            raise LockOrderError(
                "lock-order cycle (latent deadlock) in the acquisition "
                "graph:\n" + detail)
