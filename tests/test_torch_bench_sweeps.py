"""fig10 (failure count and fraction), fig11 (PLS against AUC
degradation) and fig12 (paired priority-save gain) of the port's harness
against the reference's, on the CPU at the small size of
``test_torch_bench.py`` (its fixture, tolerances and gaps), each cut to a
few emulations: fig10 two failures at two fractions, fig11 three points a
mode, fig12 one seed.

The derived rows of fig11 and fig12 come from unrounded per-run results,
so the port's ``derived`` is fed the reference's own results (recorded
around its ``run_emulation``) and must give the reference's derived rows.
"""
import pytest

# first: it puts the repo root (the harnesses' packages) on sys.path
from test_torch_bench import (assert_rows_match, auc_tol,  # noqa: F401
                              one_torch_thread, recording, small)

from benchmarks import fig10_failures as R10
from benchmarks import fig11_pls_accuracy as R11
from benchmarks import fig12_ssu_slope as R12
from benchmarks_torch import fig10_failures as T10
from benchmarks_torch import fig11_pls_accuracy as T11
from benchmarks_torch import fig12_ssu_slope as T12


def test_fig10_rows_match_the_reference(small):  # noqa: F811
    kw = dict(n_failures=(2,), fractions=(0.25, 0.5))
    ref = R10.run(**kw)
    port = T10.run(**kw, device="cpu", init_params=small)
    # every row is cpr-ssu or its fallback: the AUC limit is SSU's
    assert_rows_match(ref, port,
                      exact=("n_failures", "fraction", "mode",
                             "uses_partial", "overhead_vs_full"))
    for r, t in zip(ref, port):
        assert abs(t["auc"] - r["auc"]) <= auc_tol({"mode": "cpr-ssu"})


@pytest.fixture(scope="module")
def fig11(small):  # noqa: F811
    with pytest.MonkeyPatch.context() as mp:
        results = recording(mp, R11)
        ref = R11.run(n_points=3)
    port = T11.run(n_points=3, device="cpu", init_params=small)
    return ref, port, results


@pytest.mark.parametrize("mode", ["cpr", "cpr-ssu"])
def test_fig11_rows_match_the_reference(fig11, mode):
    ref, port, _ = fig11
    ref, port = ([r for r in rows if r["mode"] == mode]
                 for rows in (ref, port))
    assert_rows_match(ref[:-1], port[:-1],
                      exact=("mode", "point", "n_failures", "fraction",
                             "T_save_h", "pls"))
    for r, t in zip(ref, port):
        # the degradation is no-failure AUC minus the run's: two AUC gaps
        key = "auc_degradation" if "point" in r else "no_failure_auc"
        assert abs(t[key] - r[key]) <= 2 * auc_tol(r), (key, r, t)


def test_fig11_derived_rows_from_the_reference_results(fig11):
    ref, _, results = fig11
    base, runs = results[0].auc, results[1:]
    n = len(runs) // 2
    assert T11.derived("cpr", runs[:n], base) == ref[n]
    assert T11.derived("cpr-ssu", runs[n:], base) == ref[-1]


def test_fig12_rows_match_the_reference(small, monkeypatch):  # noqa: F811
    results = recording(monkeypatch, R12)
    ref = R12.run(seeds=(201,))
    port = T12.run(seeds=(201,), device="cpu", init_params=small)
    assert_rows_match(ref[:3], port[:3], exact=("mode", "mean_pls"),
                      close=("mean_auc",))
    for r, t in zip(ref[:3], port[:3]):
        for a, b in zip(r["auc_per_seed"], t["auc_per_seed"]):
            assert abs(a - b) <= auc_tol(r)
    aucs = {m: [results[i].auc] for i, m in enumerate(T12.MODES)}
    assert T12.derived(aucs) == ref[3:]
    assert [list(r) for r in port[3:]] == [list(r) for r in ref[3:]]
