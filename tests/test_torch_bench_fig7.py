"""fig7 (overhead and AUC of the six strategies) and fig9 (target-PLS
sensitivity) of the port's harness against the reference's, on the CPU at
the small size of ``test_torch_bench.py`` (its fixture, tolerances and
gaps).  fig7 runs the Kaggle layout; fig9 one target PLS."""
import pytest

# first: it puts the repo root (the harnesses' packages) on sys.path
from test_torch_bench import (assert_rows_match,  # noqa: F401
                              one_torch_thread, small)

from benchmarks import fig7_overhead as R7
from benchmarks import fig9_pls_sensitivity as R9
from benchmarks_torch import fig7_overhead as T7
from benchmarks_torch import fig9_pls_sensitivity as T9

FIG7_POLICY = ("dataset", "mode", "overhead_frac", "save_h", "load_h",
               "lost_h", "resched_h", "pls")


@pytest.fixture(scope="module")
def fig7(small):  # noqa: F811
    return (R7.run(datasets=("kaggle",)),
            T7.run(datasets=("kaggle",), device="cpu", init_params=small))


@pytest.mark.parametrize("mode", T7.MODES)
def test_fig7_row_matches_the_reference(fig7, mode):
    ref, port = ([r for r in rows if r["mode"] == mode] for rows in fig7)
    assert_rows_match(ref, port, exact=FIG7_POLICY, close=("auc",))


def test_fig7_derived_row_from_the_reference_rows(fig7):
    ref, port = fig7
    assert T7.derived(ref[:-1]) == ref[-1:]
    assert_rows_match(ref[-1:], port[-1:],
                      exact=("dataset", "mode", "overhead_reduction_pct"),
                      close=("auc_delta",))


def test_fig7_modes_subset_has_no_derived_row_without_full_and_cpr():
    rows = [{"figure": "fig7", "dataset": "kaggle", "mode": "full",
             "overhead_frac": 0.05, "auc": 0.8}]
    assert T7.derived(rows) == []


@pytest.mark.parametrize("mode", ["cpr", "cpr-ssu"])
def test_fig9_rows_match_the_reference(small, mode):  # noqa: F811
    ref = R9.run(pls_values=(0.1,), modes=(mode,))
    port = T9.run(pls_values=(0.1,), modes=(mode,), device="cpu",
                  init_params=small)
    assert_rows_match(ref, port,
                      exact=("mode", "target_pls", "expected_pls",
                             "measured_pls", "overhead_frac", "T_save_h"),
                      close=("auc",))
