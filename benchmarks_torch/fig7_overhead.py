"""Paper Fig. 7: checkpoint-related overhead and final AUC per strategy,
on the emulation of the production cluster (Kaggle + Terabyte layouts).

``modes`` picks a subset of the strategies; ``emu`` goes to
``run_emulation`` (device, tracker backend, table scale, step cap,
initial parameters)."""
from __future__ import annotations

from benchmarks_torch.common import run_emulation

MODES = ["full", "partial", "cpr", "cpr-scar", "cpr-mfu", "cpr-ssu"]


def overhead_row(ds, mode, r):
    o = r.report["overheads"]
    return {
        "figure": "fig7", "dataset": ds, "mode": mode,
        "auc": round(r.auc, 4),
        "overhead_frac": round(o["fraction"], 4),
        "save_h": round(o["save"], 3), "load_h": round(o["load"], 3),
        "lost_h": round(o["lost"], 3),
        "resched_h": round(o["resched"], 3),
        "pls": round(r.report["measured_pls"], 4),
        "wall_s": round(r.report["wall_s"], 1),
    }


def derived(rows):
    """Overhead reduction of CPR vs full recovery (paper: 93.7 %), per
    dataset whose rows hold both strategies."""
    out = []
    for ds in dict.fromkeys(r["dataset"] for r in rows):
        by_mode = {r["mode"]: r for r in rows if r["dataset"] == ds}
        if "full" not in by_mode or "cpr" not in by_mode:
            continue
        full, cpr = by_mode["full"], by_mode["cpr"]
        out.append({
            "figure": "fig7-derived", "dataset": ds, "mode": "cpr-vs-full",
            "overhead_reduction_pct": round(
                100 * (1 - cpr["overhead_frac"] / full["overhead_frac"]), 1),
            "auc_delta": round(cpr["auc"] - full["auc"], 4),
        })
    return out


def run(datasets=("kaggle", "terabyte"), modes=MODES, **emu):
    rows = [overhead_row(ds, mode, run_emulation(mode, dataset=ds, **emu))
            for ds in datasets for mode in modes]
    return rows + derived(rows)
