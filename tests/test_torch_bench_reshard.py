"""The port's fig16 (``benchmarks_torch.fig16_reshard``) against the
reference's, on the CPU, at the same small size: per transport, the
deterministic fields (``total_rows``, ``moved_mb``, the transitions)
equal and every audit true on both sides.  The timing fields
(``live_pause_ms``, ``restart_ms``) and ``steps_during_reshard`` are the
device's own and are never compared; the image after the reshard is
audited on each side against its own oracle.
"""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import benchmarks.fig16_reshard as R16  # noqa: E402
import benchmarks_torch.fig16_reshard as T16  # noqa: E402
from test_torch_bench_fleet import EXACT, _audits_true, _side_by_side  # noqa: E402,E501

FIG16 = {"max_rows": 2000, "n_ops": 3}


@pytest.mark.parametrize("backend", ["inproc", "pipe"])
def test_fig16_rows_match_reference(backend):
    want, got = _side_by_side(
        lambda: R16.run(**FIG16, backends=(backend,)),
        lambda: T16.run(**FIG16, backends=(backend,), device="cpu"))
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert set(a) == set(b)
        assert {k: a[k] for k in EXACT["reshard"]} == \
            {k: b[k] for k in EXACT["reshard"]}
        _audits_true(a)
        _audits_true(b)
