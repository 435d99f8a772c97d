"""Static + runtime invariant analysis for the port's CPR writer fleet.

The port's own copy of ``repro.analysis``, run over the port and imported
by nothing of the reference.  ``python -m repro_torch.analysis`` runs the
AST checkers (durability ordering, time sources, lock discipline, epoch
threading, exception hygiene, protocol conformance, wire-doc drift) over
the ``repro_torch`` package and exits non-zero on any unsuppressed
finding.  ``repro_torch.analysis.lockorder`` is the opt-in runtime
lock-order sanitizer (``LockOrderSanitizer()`` tracks the locks that
``repro_torch`` source constructs), and ``repro_torch.analysis.protocol``
the wire spec, its model checker and its fuzzer.  See docs/analysis.md.
"""
from repro_torch.analysis.core import (CHECKERS, Checker,  # noqa: F401
                                       Finding, Report, Source,
                                       default_root, load_baseline,
                                       register, run_analysis,
                                       write_baseline)
