"""CLI for the protocol spec tooling (the port's own copy of
``python -m repro.analysis.protocol``).

    python -m repro_torch.analysis.protocol --check [--fast] [--mutant NAME]
        exhaustively model-check the DRAIN/STAMP/takeover protocol:
        baseline must satisfy every stamp-safety invariant, every
        seeded mutant must be caught with a counterexample trace.
    python -m repro_torch.analysis.protocol --table
        print the spec-derived wire table (what docs/recovery.md must
        embed between the wire-spec markers).
    python -m repro_torch.analysis.protocol --write-table [--doc PATH]
        regenerate the wire table inside docs/recovery.md in place.
    python -m repro_torch.analysis.protocol --fuzz [--frames N] [--seed S]
            [--device cpu]
        spec-derived fuzz of a live shard_server whose fleet's tables
        lie on the device (cuda unless --device cpu; needs numpy and
        torch; asserts poison-not-corrupt — see protocol/fuzz.py).
"""
from __future__ import annotations

import argparse
import os
import sys

from repro_torch.analysis.protocol import spec
from repro_torch.analysis.protocol.model import MUTANTS, run_check


def _default_doc() -> str:
    here = os.path.abspath(spec.__file__)
    for _ in range(5):
        here = os.path.dirname(here)
    return os.path.join(here, "docs", "recovery.md")


def write_table(doc_path: str) -> int:
    with open(doc_path, encoding="utf-8") as f:
        text = f.read()
    begin, end = spec.WIRE_TABLE_BEGIN, spec.WIRE_TABLE_END
    if begin not in text or end not in text:
        print(f"{doc_path}: missing {begin} / {end} markers",
              file=sys.stderr)
        return 2
    head, rest = text.split(begin, 1)
    _, tail = rest.split(end, 1)
    new = head + begin + "\n" + spec.render_wire_table() + end + tail
    if new == text:
        print(f"{doc_path}: wire table already up to date")
        return 0
    with open(doc_path, "w", encoding="utf-8") as f:
        f.write(new)
    print(f"{doc_path}: wire table regenerated from the spec")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.protocol",
        description="wire-spec tooling: model checker, table "
                    "generator, fuzzer")
    ap.add_argument("--check", action="store_true",
                    help="explicit-state model check (baseline + "
                         "seeded mutants)")
    ap.add_argument("--fast", action="store_true",
                    help="smaller save budget per cycle (CI-bounded "
                         "state space)")
    ap.add_argument("--mutant", choices=sorted(MUTANTS),
                    help="check only this seeded mutant")
    ap.add_argument("--table", action="store_true",
                    help="print the spec-derived wire table")
    ap.add_argument("--write-table", action="store_true",
                    help="regenerate the wire table in docs/recovery.md")
    ap.add_argument("--doc", default=None,
                    help="docs file for --write-table (default: the "
                         "repo's docs/recovery.md)")
    ap.add_argument("--fuzz", action="store_true",
                    help="fuzz a live shard_server (spawns one; "
                         "needs numpy and torch)")
    ap.add_argument("--frames", type=int, default=500,
                    help="malformed frames to send with --fuzz")
    ap.add_argument("--seed", type=int, default=0,
                    help="fuzzer PRNG seed")
    ap.add_argument("--device", default=None,
                    help="the fuzzed fleet's table device (default: cuda)")
    args = ap.parse_args(argv)

    if args.table:
        sys.stdout.write(spec.render_wire_table())
        return 0
    if args.write_table:
        return write_table(args.doc or _default_doc())
    if args.fuzz:
        from repro_torch.analysis.protocol.fuzz import run_fuzz
        stats = run_fuzz(frames=args.frames, seed=args.seed,
                         device=args.device)
        print("fuzz stats:", stats)
        return 0
    if args.check:
        return run_check(fast=args.fast, mutant=args.mutant)
    ap.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
