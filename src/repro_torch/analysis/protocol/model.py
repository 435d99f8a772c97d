"""Explicit-state model checker for the DRAIN/STAMP/takeover protocol.

A small abstraction of the system the spec describes — one primary
coordinator (C0), one standby (C1), N writers, and the durable disk
state (manifest cycle stamps + the COORDINATOR epoch file) — explored
exhaustively by breadth-first search over every interleaving of:

* save frames (per-coordinator, per-writer send / apply / parity fold),
* writer SIGKILLs (durable ``applied`` survives, soft parity stripes
  held *by* the dead writer vanish),
* coordinator takeover (standby claims ``disk_epoch + 1``, writes
  COORDINATOR, re-points every live writer's session epoch — the old
  primary keeps running: split-brain is a reachable state, the
  invariants say it must be harmless),
* stale rejections (a writer refusing a frame from a superseded epoch
  latches that coordinator's cycle),
* DRAIN barriers and STAMP appends (with the pre-STAMP COORDINATOR
  re-read guard).

Writers per coordinator *stream* track ``sent >= applied >= folded``:
``applied`` is the durable watermark (an ack in the wire protocol is
the durability receipt, so apply==ack here), ``folded`` is how much of
the writer's applied history its parity holder has absorbed.

The stamp-safety invariants checked at every transition:

  I1  a stamped cycle never references an unacked event
      (stamp watermark <= the stamping stream's durable ``applied``);
  I2  COORDINATOR epochs strictly increase on every disk write;
  I3  at most one stamper per epoch, and a stamp's epoch always equals
      the on-disk epoch at append time (the re-read guard's job);
  I4  parity reconstruction never adopts a stale stripe (an adopted
      stripe equals the victim's applied history exactly);
  I5  without a fresh stripe, recovery lands exactly on the last
      stamped cycle.

``MUTANTS`` are deliberately-seeded protocol bugs (drop the pre-STAMP
re-read, stamp the sent-not-acked watermark, adopt stale stripes, reuse
an epoch on takeover); ``--check`` proves the baseline clean and every
mutant caught, printing the counterexample trace.  Pure stdlib.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple


class Coord(NamedTuple):
    status: str            # active | standby | aborted | stale | done
    epoch: int
    sent: Tuple[int, ...]     # save frames sent, per writer
    applied: Tuple[int, ...]  # durably applied+acked, per writer
    folded: Tuple[int, ...]   # victim-j frames folded into j's holder


class State(NamedTuple):
    disk_epoch: int
    stamps: Tuple[Tuple[int, int, Tuple[int, ...]], ...]  # (epoch,c,wms)
    alive: Tuple[bool, ...]
    sess_epoch: Tuple[int, ...]
    coords: Tuple[Coord, ...]
    crashes: int
    takeovers: int


class Violation(NamedTuple):
    invariant: str
    message: str


class Scope(NamedTuple):
    n_writers: int = 2
    saves: Tuple[int, ...] = (2, 1)   # save frames per coordinator cycle
    max_crashes: int = 1
    max_takeovers: int = 1


FAST = Scope(saves=(1, 1))
FULL = Scope(saves=(2, 1))

MUTANTS = {
    "skip-stamp-reread":
        "STAMP without re-reading COORDINATOR: a superseded primary "
        "stamps after the standby's takeover (violates I3)",
    "stamp-unacked":
        "stamp the sent watermark without waiting for acks "
        "(violates I1)",
    "adopt-stale-stripe":
        "reconstruction adopts the surviving parity stripe without the "
        "freshness check (violates I4)",
    "reuse-epoch":
        "takeover claims disk_epoch instead of disk_epoch + 1 "
        "(violates I2)",
}


def _tset(t: tuple, i: int, v) -> tuple:
    return t[:i] + (v,) + t[i + 1:]


def initial_state(scope: Scope) -> State:
    n = scope.n_writers
    zeros = (0,) * n
    return State(
        disk_epoch=1,
        stamps=((1, 0, zeros),),     # the run's first stamp, cycle 0
        alive=(True,) * n,
        sess_epoch=(1,) * n,
        coords=(
            Coord("active", 1, zeros, zeros, zeros),
            Coord("standby", 0, zeros, zeros, zeros),
        ),
        crashes=0,
        takeovers=0,
    )


def _last_stamp_wm(st: State, j: int) -> int:
    return st.stamps[-1][2][j]


def _holder(scope: Scope, j: int) -> int:
    return (j + 1) % scope.n_writers


# ---------------------------------------------------------------------
# transition relation: yields (label, successor | Violation)

def successors(st: State, scope: Scope,
               mutant: Optional[str]) -> Iterator[Tuple[str, object]]:
    n = scope.n_writers
    for ci, c in enumerate(st.coords):
        if c.status != "active":
            continue
        # -- send one more save frame to a live writer ----------------
        for j in range(n):
            if st.alive[j] and c.sent[j] < scope.saves[ci]:
                nc = c._replace(sent=_tset(c.sent, j, c.sent[j] + 1))
                yield (f"C{ci}: send save#{c.sent[j] + 1} -> w{j}",
                       st._replace(coords=_tset(st.coords, ci, nc)))
        # -- writer applies / stale-rejects the oldest in-flight frame
        for j in range(n):
            if not st.alive[j] or c.applied[j] >= c.sent[j]:
                continue
            if c.epoch >= st.sess_epoch[j]:
                nc = c._replace(
                    applied=_tset(c.applied, j, c.applied[j] + 1))
                yield (f"w{j}: apply+ack save#{c.applied[j] + 1} "
                       f"from C{ci}",
                       st._replace(coords=_tset(st.coords, ci, nc)))
            else:
                # epoch fence: ("stale", ...) latches the endpoint
                nc = c._replace(status="aborted")
                yield (f"w{j}: stale-reject C{ci} (cmd epoch {c.epoch} "
                       f"< session epoch {st.sess_epoch[j]})",
                       st._replace(coords=_tset(st.coords, ci, nc)))
        # -- parity: the holder folds one applied frame ----------------
        for j in range(n):
            h = _holder(scope, j)
            if st.alive[h] and c.folded[j] < c.applied[j]:
                nc = c._replace(
                    folded=_tset(c.folded, j, c.folded[j] + 1))
                yield (f"w{h}: fold parity of w{j} save#"
                       f"{c.folded[j] + 1} (C{ci} stream)",
                       st._replace(coords=_tset(st.coords, ci, nc)))
        # -- DRAIN + STAMP --------------------------------------------
        yield from _stamp(st, scope, ci, c, mutant)
    # -- writer SIGKILL -----------------------------------------------
    if st.crashes < scope.max_crashes:
        for j in range(n):
            if st.alive[j]:
                yield (f"w{j}: SIGKILL",
                       st._replace(alive=_tset(st.alive, j, False),
                                   crashes=st.crashes + 1))
    # -- standby takeover ---------------------------------------------
    if st.takeovers < scope.max_takeovers:
        yield from _takeover(st, mutant)


def _drained(c: Coord, st: State, scope: Scope, ci: int,
             mutant: Optional[str]) -> Optional[Tuple[int, ...]]:
    """Per-writer stamp watermarks once the DRAIN barrier is complete —
    None while saves are still in flight.  Dead writers roll back to
    the previous stamp (their cycle did not complete)."""
    wms = []
    for j in range(len(st.alive)):
        if not st.alive[j]:
            wms.append(_last_stamp_wm(st, j))
            continue
        if c.sent[j] < scope.saves[ci]:
            return None                  # cycle's saves not all sent yet
        if mutant == "stamp-unacked":
            wms.append(c.sent[j])        # BUG: not waiting for the ack
        else:
            if c.applied[j] < c.sent[j]:
                return None              # drained reply not back yet
            wms.append(c.applied[j])
    return tuple(wms)


def _stamp(st: State, scope: Scope, ci: int, c: Coord,
           mutant: Optional[str]) -> Iterator[Tuple[str, object]]:
    wms = _drained(c, st, scope, ci, mutant)
    if wms is None:
        return
    label = f"C{ci}: STAMP cycle wm={wms} under epoch {c.epoch}"
    # the pre-STAMP COORDINATOR re-read: a successor's claim aborts us
    if mutant != "skip-stamp-reread" and st.disk_epoch != c.epoch:
        nc = c._replace(status="stale")
        yield (f"C{ci}: pre-STAMP re-read sees epoch {st.disk_epoch} "
               f"!= {c.epoch}: abort (StaleCoordinatorError)",
               st._replace(coords=_tset(st.coords, ci, nc)))
        return
    # I1: a stamp never references an unacked event
    for j in range(len(wms)):
        if st.alive[j] and wms[j] > c.applied[j]:
            yield (label, Violation(
                "I1", f"stamp watermark {wms[j]} for w{j} exceeds its "
                      f"durable applied count {c.applied[j]}: the "
                      f"stamped cycle references an unacked event"))
            return
    # I3: one stamper per epoch; stamp epoch == on-disk epoch
    if st.disk_epoch != c.epoch:
        yield (label, Violation(
            "I3", f"C{ci} stamps under epoch {c.epoch} while the disk "
                  f"COORDINATOR epoch is {st.disk_epoch}: a superseded "
                  f"primary stamped after a takeover"))
        return
    for (e, owner, _) in st.stamps:
        if e == c.epoch and owner != ci:
            yield (label, Violation(
                "I3", f"epoch {c.epoch} has two stampers "
                      f"(C{owner} and C{ci})"))
            return
    nc = c._replace(status="done")
    yield (label, st._replace(
        stamps=st.stamps + ((c.epoch, ci, wms),),
        coords=_tset(st.coords, ci, nc)))


def _takeover(st: State,
              mutant: Optional[str]) -> Iterator[Tuple[str, object]]:
    ci = next((i for i, c in enumerate(st.coords)
               if c.status == "standby"), None)
    if ci is None:
        return
    new_epoch = (st.disk_epoch if mutant == "reuse-epoch"
                 else st.disk_epoch + 1)
    label = (f"C{ci}: takeover — claim epoch {new_epoch}, write "
             f"COORDINATOR, re-point live sessions")
    # I2: COORDINATOR epoch writes strictly increase
    if new_epoch <= st.disk_epoch:
        yield (label, Violation(
            "I2", f"takeover writes COORDINATOR epoch {new_epoch} over "
                  f"{st.disk_epoch}: epochs must strictly increase or "
                  f"the fence cannot order coordinators"))
        return
    nc = st.coords[ci]._replace(status="active", epoch=new_epoch)
    sess = tuple(new_epoch if st.alive[j] else st.sess_epoch[j]
                 for j in range(len(st.alive)))
    yield (label, st._replace(
        disk_epoch=new_epoch, sess_epoch=sess,
        coords=_tset(st.coords, ci, nc),
        takeovers=st.takeovers + 1))


def _check_recovery(st: State, scope: Scope,
                    mutant: Optional[str]) -> Optional[Violation]:
    """I4/I5, evaluated on every state with a dead writer: what would
    ``reconstruct_shard`` / ``load_latest`` recover right now?"""
    for j in range(scope.n_writers):
        if st.alive[j]:
            continue
        h = _holder(scope, j)
        streams = [c for c in st.coords if c.status != "standby"]
        fresh = st.alive[h] and all(c.folded[j] == c.applied[j]
                                    for c in streams)
        adopt = st.alive[h] if mutant == "adopt-stale-stripe" else fresh
        if adopt:
            # I4: an adopted stripe must equal the victim's history
            for c in streams:
                if c.folded[j] != c.applied[j]:
                    return Violation(
                        "I4", f"reconstruction of w{j} adopts a stripe "
                              f"holding {c.folded[j]} of {c.applied[j]} "
                              f"applied saves: stale stripe adopted")
        else:
            # I5: fall back exactly to the last stamped cycle
            wm = _last_stamp_wm(st, j)
            ceiling = max([c.applied[j] for c in streams] or [0])
            if wm > ceiling:
                return Violation(
                    "I5", f"recovery of w{j} lands on watermark {wm} "
                          f"beyond its durable history {ceiling}: not "
                          f"a stamped-cycle state")
    return None


# ---------------------------------------------------------------------
# exhaustive exploration


class Result(NamedTuple):
    states: int
    transitions: int
    violation: Optional[Violation]
    trace: List[str]          # action labels root -> violation


def explore(scope: Scope = FULL, mutant: Optional[str] = None,
            max_states: int = 2_000_000) -> Result:
    if mutant is not None and mutant not in MUTANTS:
        raise ValueError(f"unknown mutant {mutant!r} "
                         f"(known: {', '.join(sorted(MUTANTS))})")
    root = initial_state(scope)
    parent: Dict[State, Optional[Tuple[State, str]]] = {root: None}
    queue = deque([root])
    transitions = 0

    def trace_to(st: State, final_label: Optional[str]) -> List[str]:
        labels: List[str] = []
        cur: Optional[State] = st
        while parent[cur] is not None:
            prev, label = parent[cur]
            labels.append(label)
            cur = prev
        labels.reverse()
        if final_label is not None:
            labels.append(final_label)
        return labels

    while queue:
        st = queue.popleft()
        bad = _check_recovery(st, scope, mutant)
        if bad is not None:
            return Result(len(parent), transitions, bad,
                          trace_to(st, f"<< {bad.invariant} violated"
                                       f" in this state >>"))
        for label, nxt in successors(st, scope, mutant):
            transitions += 1
            if isinstance(nxt, Violation):
                return Result(len(parent), transitions, nxt,
                              trace_to(st, label))
            if nxt not in parent:
                if len(parent) >= max_states:
                    raise RuntimeError(
                        f"state space exceeds {max_states} states — "
                        f"shrink the scope")
                parent[nxt] = (st, label)
                queue.append(nxt)
    return Result(len(parent), transitions, None, [])


def _print_trace(res: Result) -> None:
    print(f"  counterexample ({len(res.trace)} steps):")
    for i, label in enumerate(res.trace, 1):
        print(f"    {i:2d}. {label}")
    print(f"  violation [{res.violation.invariant}]: "
          f"{res.violation.message}")


def run_check(fast: bool = False, mutant: Optional[str] = None,
              quiet: bool = False) -> int:
    """Baseline must be violation-free; every mutant must be caught.
    Returns a process exit code."""
    scope = FAST if fast else FULL
    mutants = [mutant] if mutant else sorted(MUTANTS)
    say = (lambda *a: None) if quiet else print
    say(f"scope: {scope.n_writers} writers, saves/cycle {scope.saves}, "
        f"<= {scope.max_crashes} writer crash(es), "
        f"<= {scope.max_takeovers} takeover(s)")
    res = explore(scope)
    if res.violation is not None:
        say("BASELINE VIOLATION — the protocol model itself is broken:")
        _print_trace(res)
        return 1
    say(f"baseline: {res.states} states / {res.transitions} "
        f"transitions exhausted, all invariants hold")
    failed = []
    for name in mutants:
        res = explore(scope, mutant=name)
        if res.violation is None:
            failed.append(name)
            say(f"mutant {name}: NOT CAUGHT "
                f"({res.states} states) — checker has a blind spot")
        else:
            say(f"mutant {name}: caught "
                f"[{res.violation.invariant}] after {res.states} states")
            if not quiet:
                _print_trace(res)
    return 1 if failed else 0
