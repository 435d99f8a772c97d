"""Paper Fig. 9: varying target PLS trades off overhead and accuracy
(CPR-vanilla and CPR-SSU, Kaggle)."""
from __future__ import annotations

from benchmarks_torch.common import run_emulation


def run(pls_values=(0.02, 0.1, 0.2), modes=("cpr", "cpr-ssu"), **emu):
    rows = []
    for mode in modes:
        for pls in pls_values:
            r = run_emulation(mode, target_pls=pls, **emu)
            rows.append({
                "figure": "fig9", "mode": mode, "target_pls": pls,
                "expected_pls": round(r.report["expected_pls"], 4),
                "measured_pls": round(r.report["measured_pls"], 4),
                "auc": round(r.auc, 4),
                "overhead_frac": round(r.report["overheads"]["fraction"], 4),
                "T_save_h": round(r.report["T_save"], 2),
            })
    return rows
