"""Paper Fig. 13: analytic scalability of full recovery vs CPR under the
linear-MTBF and independent-failure models."""
from __future__ import annotations

from repro_torch.core import scalability_curve


def run(node_counts=(4, 8, 16, 32, 64, 128, 256)):
    rows = []
    for model in ("linear", "independent"):
        for r in scalability_curve(node_counts, failure_model=model):
            rows.append({"figure": "fig13", "failure_model": model, **{
                k: (round(v, 5) if isinstance(v, float) else v)
                for k, v in r.items()}})
    return rows
