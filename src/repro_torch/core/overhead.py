"""Checkpoint-overhead model and CPR interval policy (paper §2.2, §4.1).

A copy of ``repro.core.overhead`` (math only): ``choose_strategy`` must
give the reference's decisions exactly.

Equations (paper numbering):
  Eq.1  O_total(full)    ≈ O_save·T/T_save + (O_load + T_save/2 + O_res)·T/T_fail
  Eq.2  O_total(partial) ≈ O_save·T/T_save + (O_load + O_res)·T/T_fail
  Eq.4  E[PLS]           = 0.5·T_save / (T_fail·N_emb)
        T_save,full  = sqrt(2·O_save·T_fail)
        T_save,part  = 2·PLS·N_emb·T_fail
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class SystemParams:
    """Failure/overhead characteristics of the cluster (units: hours).

    Defaults are projected from the paper's production measurements so the
    56-hour emulation reproduces the paper's overhead percentages
    (full ≈ 8.2–8.5 %, naive partial ≈ 4.4 %, CPR ≈ 0.5–0.7 %).
    """
    T_total: float = 56.0
    T_fail: float = 28.0          # MTBF (2 expected failures in 56 h)
    N_emb: int = 8                # number of Emb PS shards
    O_save: float = 0.06          # full-checkpoint save cost
    O_load: float = 0.10          # full-checkpoint load cost
    O_load_partial: float = 0.0125  # one-shard load cost (≈ O_load / N_emb)
    O_res: float = 0.25           # rescheduling (full recovery: all nodes)
    O_res_partial: float = 0.10   # rescheduling (partial: failed node only)


def full_recovery_overhead(p: SystemParams, T_save: float) -> float:
    """Eq. 1."""
    n_saves = p.T_total / T_save
    n_fails = p.T_total / p.T_fail
    return p.O_save * n_saves + (p.O_load + T_save / 2 + p.O_res) * n_fails


def partial_recovery_overhead(p: SystemParams, T_save: float) -> float:
    """Eq. 2 (with partial-load/resched costs)."""
    n_saves = p.T_total / T_save
    n_fails = p.T_total / p.T_fail
    return p.O_save * n_saves + (p.O_load_partial + p.O_res_partial) * n_fails


def t_save_full_optimal(p: SystemParams) -> float:
    """argmin of Eq. 1: sqrt(2·O_save·T_fail)."""
    return math.sqrt(2.0 * p.O_save * p.T_fail)


def t_save_partial(p: SystemParams, target_pls: float) -> float:
    """Invert Eq. 4: the largest interval meeting the PLS target."""
    return 2.0 * target_pls * p.N_emb * p.T_fail


def expected_pls(p: SystemParams, T_save: float) -> float:
    """Eq. 4."""
    return 0.5 * T_save / (p.T_fail * p.N_emb)


def choose_strategy(p: SystemParams, target_pls: float) -> dict:
    """CPR's benefit analysis (paper Fig. 5): pick full vs partial recovery
    and the saving interval.  Falls back to full recovery when partial has
    no expected benefit.

    Note the clamp: a loose PLS target can make Eq. 4's interval exceed the
    whole run (e.g. target_pls=0.5, N_emb=8, T_fail=28 -> 224 h > T_total),
    in which case T_save_partial is clamped to T_total — the first (only)
    save then lands at the very end of the run, so every failure before it
    reverts its shards to their *initial* values.  ``t_save_partial_clamped``
    flags this regime; emulations in it measure pure failure damage.
    """
    ts_full = t_save_full_optimal(p)
    ts_part_raw = t_save_partial(p, target_pls)
    ts_part = min(ts_part_raw, p.T_total)
    o_full = full_recovery_overhead(p, ts_full)
    o_part = partial_recovery_overhead(p, ts_part)
    use_partial = o_part < o_full
    return {
        "use_partial": use_partial,
        "T_save": ts_part if use_partial else ts_full,
        "T_save_full_optimal": ts_full,
        "T_save_partial": ts_part,
        "t_save_partial_clamped": ts_part_raw > p.T_total,
        "overhead_full": o_full,
        "overhead_partial": o_part,
        "expected_pls": expected_pls(p, ts_part) if use_partial else 0.0,
        "predicted_benefit": o_full - o_part,
    }


# ---- scalability analysis (paper §6.6, Fig. 13) ---------------------------
def mtbf_linear(n_nodes: int, mtbf_single: float = 450.0) -> float:
    """MTBF ∝ 1/n (the behavior observed in §3.1)."""
    return mtbf_single / n_nodes

def mtbf_independent(n_nodes: int, p_hour: float = 0.0022) -> float:
    """Independent per-node hourly failure probability p: 1/(1-(1-p)^n)."""
    return 1.0 / (1.0 - (1.0 - p_hour) ** n_nodes)


def scalability_curve(node_counts, target_pls=0.1, failure_model="linear",
                      base: SystemParams = None):
    """Overhead fraction vs node count for full recovery and CPR (Fig. 13)."""
    base = base or SystemParams()
    rows = []
    for n in node_counts:
        tf = (mtbf_linear(n) if failure_model == "linear"
              else mtbf_independent(n))
        p = SystemParams(T_total=base.T_total, T_fail=tf, N_emb=n,
                         O_save=base.O_save, O_load=base.O_load,
                         O_load_partial=base.O_load / n,
                         O_res=base.O_res, O_res_partial=base.O_res_partial)
        o_full = full_recovery_overhead(p, t_save_full_optimal(p))
        d = choose_strategy(p, target_pls)
        o_cpr = min(d["overhead_partial"], o_full)
        rows.append({"nodes": n, "T_fail": tf,
                     "full_frac": o_full / p.T_total,
                     "cpr_frac": o_cpr / p.T_total,
                     "cpr_uses_partial": d["use_partial"]})
    return rows
