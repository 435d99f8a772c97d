"""Paper Fig. 10: sensitivity to failure count / failed fraction; includes
CPR's benefit analysis (fallback to full recovery marked)."""
from __future__ import annotations

from benchmarks_torch.common import run_emulation
from repro_torch.core import SystemParams


def run(n_failures=(2, 20, 40), fractions=(0.125, 0.25, 0.5), **emu):
    rows = []
    for nf in n_failures:
        p = SystemParams(T_fail=56.0 / nf)
        full = run_emulation("full", sys_params=p, n_failures=nf,
                             fraction=0.25, target_pls=0.02, **emu)
        base = full.report["overheads"]["total"]
        for frac in fractions:
            r = run_emulation("cpr-ssu", sys_params=p, n_failures=nf,
                              fraction=frac, target_pls=0.02, **emu)
            rows.append({
                "figure": "fig10", "n_failures": nf, "fraction": frac,
                "mode": r.report["effective_mode"],
                "uses_partial": r.report["effective_mode"] == "cpr-ssu",
                "overhead_vs_full": round(
                    r.report["overheads"]["total"] / max(base, 1e-9), 3),
                "auc": round(r.auc, 4),
            })
    return rows
