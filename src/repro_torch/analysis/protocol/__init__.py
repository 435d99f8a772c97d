"""Protocol-as-spec: the writer-fleet wire protocol as a first-class,
machine-verified artifact (the port's own copy of
``repro.analysis.protocol``).

``spec``   — the machine-readable wire spec: every frame kind's name,
             arity, field names/types, epoch slot, direction, and the
             connection states in which it is legal.  Single source of
             truth: the AST conformance rule (``rules/protocol.py``),
             the runtime frame validator in the serve loop, the wire
             table in ``docs/recovery.md``, the model checker, and the
             fuzzer all derive from it.
``model``  — explicit-state model checker over an abstracted
             coordinator + N writers + disk, exhaustively enumerating
             small-scope interleavings of frames, SIGKILLs, and
             takeovers against the stamp-safety invariants
             (``python -m repro_torch.analysis.protocol --check``).
``fuzz``   — spec-derived grammar fuzzer throwing malformed, truncated,
             wrong-state, and stale-epoch frames at a live
             ``shard_server`` and asserting poison-not-corrupt.

Everything imported here is pure stdlib: the port's transport and shard
server import ``spec`` from here.  ``fuzz`` imports torch and the live
transport and is therefore NOT imported at package level — import
``repro_torch.analysis.protocol.fuzz`` explicitly from tests or the CLI.
"""
from .spec import (FRAMES, KINDS, MAX_FRAME_BYTES, STATES, FrameSpec,
                   frames_for, render_wire_table, validate_frame)

__all__ = [
    "FRAMES",
    "KINDS",
    "MAX_FRAME_BYTES",
    "STATES",
    "FrameSpec",
    "frames_for",
    "render_wire_table",
    "validate_frame",
]
