"""Paper Fig. 12: priority partial saves (MFU/SSU) reduce the accuracy cost
of a given PLS.

Paired design (stronger than the scatter regression at this scale): one
late failure clearing 50 % of the shards with a run-length checkpoint
interval, identical failure seeds across modes — the PLS is the same, so
any AUC gap is the restored-image quality, i.e. Fig. 12's slope effect.
"""
from __future__ import annotations

import numpy as np

from benchmarks_torch.common import run_emulation

MODES = ("cpr", "cpr-mfu", "cpr-ssu")


def derived(aucs_by_mode):
    """Paired AUC gain of each priority mode over CPR-vanilla, from the
    per-seed AUCs (unrounded) of every mode."""
    base = np.array(aucs_by_mode["cpr"])
    rows = []
    for mode in MODES[1:]:
        d = np.array(aucs_by_mode[mode]) - base
        rows.append({"figure": "fig12-derived", "mode": mode,
                     "auc_gain_vs_vanilla_mean": round(float(d.mean()), 4),
                     "wins_paired": int((d > 0).sum()), "n": len(base)})
    return rows


def run(seeds=(201, 202, 203), t_save=30.0, **emu):
    rows = []
    per_mode = {}
    for mode in MODES:
        aucs, pls = [], []
        for fs in seeds:
            r = run_emulation(mode, n_failures=1, fraction=0.5, fail_seed=fs,
                              t_save_override=t_save, eval_frac=0.25, **emu)
            aucs.append(r.auc)
            pls.append(r.report["measured_pls"])
        per_mode[mode] = aucs
        rows.append({"figure": "fig12", "mode": mode,
                     "auc_per_seed": [round(a, 4) for a in aucs],
                     "mean_auc": round(float(np.mean(aucs)), 4),
                     "mean_pls": round(float(np.mean(pls)), 4)})
    return rows + derived(per_mode)
