"""Project-specific invariant checkers.  Importing this package
registers every rule with ``repro_torch.analysis.core.CHECKERS``."""
from repro_torch.analysis.rules import (durability, epochs,  # noqa: F401
                                        exceptions, locks, protocol,
                                        timesource)
