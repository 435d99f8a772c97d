"""Plain PyTorch versions of the port's kernels (the allclose targets).

They mirror ``repro.kernels.ref`` (``embedding_bag``, ``tracker_select``,
``ssu_dedupe_evict``) and add the embedding-bag backward, which the
reference leaves to XLA.  The CPU path runs them; on the card they are
only the yardstick ``chip_smoke.py`` holds each kernel against.
"""
from __future__ import annotations

import torch

EMPTY = 2 ** 31 - 1          # int32 max: an unused SSU slot


def embedding_bag(table, idx):
    """table: (N, d); idx: (B, hot) -> (B, d) sum-pooled."""
    return table[idx.long()].sum(1)


def embedding_bag_backward(grad_out, idx, n_rows: int):
    """Dense (n_rows, d) f32 gradient of ``embedding_bag`` w.r.t. the table:
    every lookup adds its bag's output gradient into its row."""
    B, hot = idx.shape
    rows = grad_out.float().repeat_interleave(hot, dim=0)   # lookup order
    grad = torch.zeros((n_rows, grad_out.shape[1]), dtype=torch.float32,
                       device=grad_out.device)
    return grad.index_add_(0, idx.reshape(-1).long(), rows)


def tracker_select(counts, indices, k: int, seg_size: int = 512):
    """MFU count fold + per-segment top-k (exact-match target).

    Folds ``indices`` (ids outside [0, N) match nothing) into ``counts``,
    then per fixed-size row segment picks the ``k`` highest-count rows
    (ties -> lowest row id) and clears their counters.  Padding rows of the
    last segment count as -1, so selected ids may reach past N; callers
    drop those.  Returns (row_ids (n_seg*k,) int32, new_counts (N,) int32).
    """
    (N,) = counts.shape
    seg = min(seg_size, max(N, 1))
    n_seg = -(-N // seg)
    k = min(k, seg)
    flat = indices.reshape(-1).long()
    flat = flat[(flat >= 0) & (flat < N)]
    folded = counts.long() + torch.bincount(flat, minlength=N)
    padded = torch.full((n_seg * seg,), -1, dtype=torch.long,
                        device=counts.device)
    padded[:N] = folded
    work = padded.view(n_seg, seg)
    # k rounds of "max, lowest index on ties" == a stable descending sort
    pos = torch.sort(work, dim=1, descending=True, stable=True).indices[:, :k]
    base = torch.arange(n_seg, device=counts.device)[:, None] * seg
    ids = (pos + base).reshape(-1).to(torch.int32)
    cleared = work.scatter(1, pos, 0).reshape(-1)[:N]
    return ids, cleared.to(torch.int32)


def ssu_dedupe_evict(buf, cand, scores):
    """SSU dedupe + random-evict (exact-match target).

    buf:    (rn,) int32 sorted ascending, EMPTY-padded at the end.
    cand:   (nc,) int32 candidates (EMPTY-padded).
    scores: (rn + nc,) float keep-scores for the sorted union.

    Returns the new (rn,) sorted buffer: candidates already present are
    dropped, then the rn best (lowest-score) live entries survive, ties
    to the lower position.
    """
    rn = buf.shape[0]
    cand = torch.where(torch.isin(cand, buf), EMPTY, cand)
    combined = torch.sort(torch.cat([buf, cand])).values
    score = torch.where(combined != EMPTY, scores, float("inf"))
    keep = torch.sort(score, stable=True).indices[:rn]
    return torch.sort(combined[keep]).values
