"""Paper Fig. 8 / §6.2: the production-scale-cluster experiment.

Setup mirrored from the paper: 18 Emb PS shards, a 10-hour job, ONE failure
injected near the end clearing 25 % of the Emb PS shards; CPR-vanilla with
target PLS 0.05 (resulting interval ≈ 4 h vs full recovery's 2 h).  The
paper reports training loss (their production job had no AUC eval) and an
overhead drop 12.5 % → 1 %.
"""
from __future__ import annotations

import numpy as np

from benchmarks_torch.common import get_dataset
from repro_torch.core import (CPRManager, Emulator, FailureEvent,
                              SystemParams)


class _LateInjector:
    """One failure at 90 % of the run (paper: 'near the end')."""

    def __init__(self, t_total, n_shards, fraction, seed=5):
        rng = np.random.default_rng(seed)
        k = max(1, int(round(fraction * n_shards)))
        ids = tuple(sorted(rng.choice(n_shards, size=k, replace=False)))
        self.events = [FailureEvent(0.9 * t_total, ids, k / n_shards)]

    def between(self, t0, t1):
        return [e for e in self.events if t0 < e.time <= t1]


def derived(rows):
    full, cpr = rows[0], rows[1]
    return {"figure": "fig8-derived",
            "overhead_full_pct": round(100 * full["overhead_frac"], 2),
            "overhead_cpr_pct": round(100 * cpr["overhead_frac"], 2),
            "loss_delta": round(cpr["train_loss"] - full["train_loss"], 4),
            "paper": "12.5% -> 1%, no loss degradation"}


def run(device=None, init_params=None):
    cfg, ds = get_dataset("kaggle")
    # production params: T_total=10h, one failure -> T_fail=10h, N_emb=18.
    # The paper *states* the intervals (full: 2 h, CPR: 4 h from PLS=0.05),
    # so we fix them rather than re-derive.
    p = SystemParams(T_total=10.0, T_fail=10.0, N_emb=18,
                     O_save=0.06, O_load=0.15, O_load_partial=0.01,
                     O_res=0.10, O_res_partial=0.02)
    rows = []
    for mode, pls, tsave in (("full", 0.05, 2.0), ("cpr", 0.05, 4.0)):
        mgr = CPRManager(mode, p, cfg.table_sizes, target_pls=pls,
                         device=device)
        mgr.T_save = tsave
        inj = _LateInjector(p.T_total, p.N_emb, 0.25)
        r = Emulator(cfg, ds, mgr, inj, batch_size=512, device=device,
                     init_params=init_params).run()
        o = r.report["overheads"]
        rows.append({
            "figure": "fig8", "mode": mode,
            "T_save_h": round(r.report["T_save"], 2),
            "train_loss": round(r.final_loss, 4),
            "logloss": round(r.logloss, 4),
            "overhead_frac": round(o["fraction"], 4),
            "pls": round(r.report["measured_pls"], 4),
        })
    return rows + [derived(rows)]
