"""Paper Figs. 11 & 12: PLS <-> final-accuracy correlation (vanilla partial
recovery), and the slope reduction from CPR-SSU."""
from __future__ import annotations

import numpy as np

from benchmarks_torch.common import run_emulation


def _corr(xs, ys):
    if len(xs) < 3 or np.std(xs) == 0 or np.std(ys) == 0:
        return float("nan")
    return float(np.corrcoef(xs, ys)[0, 1])


def derived(mode, results, base_auc):
    """The correlation and slope of AUC degradation against measured PLS
    over one mode's runs (emulation results, unrounded)."""
    pls = [r.report["measured_pls"] for r in results]
    deg = [base_auc - r.auc for r in results]
    slope = np.polyfit(pls, deg, 1)[0] if len(set(pls)) > 2 else float("nan")
    return {"figure": "fig11-derived", "mode": mode,
            "pls_accuracy_corr": round(_corr(pls, deg), 4),
            "slope_auc_per_pls": round(float(slope), 5),
            "no_failure_auc": round(base_auc, 4)}


def run(n_points=10, seed0=100, **emu):
    rng = np.random.default_rng(0)
    rows = []
    base = run_emulation("full", n_failures=0, eval_frac=0.25, **emu).auc
    for mode in ("cpr", "cpr-ssu"):
        results = []
        for i in range(n_points):
            nf = int(rng.integers(2, 17))
            frac = float(rng.choice([0.25, 0.375, 0.5]))
            tsave = float(rng.uniform(4.0, 56.0))
            r = run_emulation(mode, n_failures=nf, fraction=frac,
                              fail_seed=seed0 + i, t_save_override=tsave,
                              eval_frac=0.25, **emu)
            results.append(r)
            rows.append({"figure": "fig11", "mode": mode, "point": i,
                         "n_failures": nf, "fraction": frac,
                         "T_save_h": round(tsave, 2),
                         "pls": round(r.report["measured_pls"], 4),
                         "auc_degradation": round(base - r.auc, 5)})
        rows.append(derived(mode, results, base))
    return rows
