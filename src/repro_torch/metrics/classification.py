"""Classification metrics: ROC AUC (the paper's quality metric) and log-loss.

A copy of ``repro.metrics.classification`` (numpy only)."""
from __future__ import annotations

import numpy as np


def roc_auc(labels, scores) -> float:
    """Exact ROC AUC via the rank statistic (ties handled by midranks)."""
    labels = np.asarray(labels).astype(np.float64).ravel()
    scores = np.asarray(scores).astype(np.float64).ravel()
    pos = labels > 0.5
    n_pos = int(pos.sum())
    n_neg = labels.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty_like(scores)
    sorted_scores = scores[order]
    # midranks for ties
    i = 0
    r = np.arange(1, scores.size + 1, dtype=np.float64)
    while i < scores.size:
        j = i
        while j + 1 < scores.size and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        r[i : j + 1] = 0.5 * (i + j) + 1.0
        i = j + 1
    ranks[order] = r
    auc = (ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)
    return float(auc)


def log_loss(labels, probs, eps=1e-7) -> float:
    labels = np.asarray(labels).astype(np.float64).ravel()
    p = np.clip(np.asarray(probs).astype(np.float64).ravel(), eps, 1 - eps)
    return float(-np.mean(labels * np.log(p) + (1 - labels) * np.log(1 - p)))
