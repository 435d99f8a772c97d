"""Priority trackers for partial checkpointing (paper §4.2, Table 1).

Given constrained checkpoint bandwidth, CPR saves the rows most likely to
have large accumulated updates first.  Three implementations:

  * SCAR   (Qiao et al. 2019): track actual per-row update magnitude via a
           shadow copy of the table at the last save.  Memory 100 %,
           time O(N log N) at save.
  * CPR-MFU: a 4-byte access counter per row; save the top r·N by count,
           clear saved counters.  Time O(N log N).
  * CPR-SSU: a fixed r·N-slot deduplicated list of sub-sampled accessed row
           ids with random eviction on overflow (memory r× MFU).

The port of ``repro.core.trackers``.  Two of the reference's semantics are
kept by construction: ``jax.lax.top_k`` puts the lower index first on
ties, so selections here take the first ``rn`` of a *stable* descending
sort (``torch.topk`` promises no tie order, and the integer counters tie
massively); and ``jnp.unique(size=, fill_value=EMPTY)`` becomes a sorted
``torch.unique`` padded with EMPTY on the host backend, and the
``ssu_dedupe_evict`` kernel's own dedupe on the kernel backend.  The SSU
state holds a per-table ``torch.Generator`` in place of the jax key; its
keep-scores are drawn before the backend branch, so the host and kernel
backends agree given the same stream.  ``EMPTY`` (int32 max) marks unused
SSU slots.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import EMPTY


def _top_rows(values, rn: int):
    """Indices of the ``rn`` largest values, ties to the lower index, as
    int32 (the reference's ``jax.lax.top_k`` order)."""
    order = torch.sort(values, descending=True, stable=True).indices[:rn]
    return order.to(torch.int32)


# ------------------------------------------------------------------ MFU ----
def mfu_init(num_rows: int, device):
    return torch.zeros(num_rows, dtype=torch.int32, device=device)


def mfu_update(counts, indices):
    """indices: any int tensor of accessed row ids."""
    flat = indices.reshape(-1).long()
    return counts.index_add(0, flat, torch.ones_like(flat, dtype=counts.dtype))


def mfu_select(counts, rn: int):
    """Top r·N rows by access count -> (row_ids int32, cleared_counts)."""
    rn = min(rn, counts.shape[0])
    idx = _top_rows(counts, rn)
    return idx, counts.index_fill(0, idx.long(), 0)


def segmented_k(n: int, rn: int, seg_size: int = 512):
    """(seg, k) plan for segment-wise selection: segment width and the
    per-segment quota covering rn rows total."""
    seg = min(seg_size, max(n, 1))
    n_seg = -(-n // seg)
    return seg, max(1, min(-(-rn // n_seg), seg))


def mfu_select_segmented(counts, rn: int, indices=None, seg_size: int = 512):
    """Fused MFU update + segment-wise top-k (the ``tracker_select``
    kernel on CUDA).  ``indices`` are pending accessed ids not yet counted.
    Selected ids may include padding picks >= N; callers drop those.
    Returns (row_ids, new_counts) like ``mfu_select``.

    Caveat (as in the reference): the per-segment quota matches global
    top-k only when hot rows are spread across segments.
    """
    seg, k = segmented_k(counts.shape[0], rn, seg_size)
    if indices is None:
        indices = torch.zeros(0, dtype=torch.int32, device=counts.device)
    return ops.tracker_select(counts, indices, k, seg_size=seg)


# ------------------------------------------------------------------ SSU ----
def ssu_init(rn: int, seed: int = 17, device=None):
    """``seed`` decorrelates eviction streams across tracker instances."""
    return {"buf": torch.full((rn,), EMPTY, dtype=torch.int32, device=device),
            "gen": torch.Generator(device=device).manual_seed(seed)}


def ssu_update(state, indices, period: int = 2, backend: str = "host",
               scores=None):
    """Insert every ``period``-th accessed id; dedupe; random-evict overflow.

    Keeps the buffer sorted ascending with EMPTY slots at the end.
    ``backend="kernel"`` hands the raw strided candidates to
    ``ops.ssu_dedupe_evict``, which dedupes them itself, so on the card the
    update makes no host sync.  ``scores`` (rn + nc keep-scores) replaces
    the draw from the state's generator, so a test can hand both sides
    the same stream.
    """
    buf, gen = state["buf"], state["gen"]
    rn = buf.shape[0]
    cand = indices.reshape(-1)[::period].to(torch.int32)
    nc = cand.shape[0]
    if scores is None:
        scores = torch.rand(rn + nc, generator=gen, device=buf.device,
                            dtype=torch.float32)
    if backend == "kernel":
        return {"buf": ops.ssu_dedupe_evict(buf, cand.contiguous(), scores),
                "gen": gen}
    uniq = torch.unique(cand, sorted=True)
    cand = torch.full((nc,), EMPTY, dtype=torch.int32, device=buf.device)
    cand[:uniq.shape[0]] = uniq
    # drop candidates already present
    pos = torch.searchsorted(buf, cand)
    present = buf[pos.clamp(0, rn - 1)] == cand
    cand = torch.where(present, EMPTY, cand)
    combined = torch.sort(torch.cat([buf, cand])).values
    score = torch.where(combined != EMPTY, scores, float("inf"))
    keep = torch.sort(score, stable=True).indices[:rn]
    return {"buf": torch.sort(combined[keep]).values, "gen": gen}


def ssu_select(state):
    """Rows to save -> (row_ids (padded with EMPTY), reset_state)."""
    return state["buf"], {"buf": torch.full_like(state["buf"], EMPTY),
                          "gen": state["gen"]}


# ----------------------------------------------------------------- SCAR ----
def scar_init(table):
    return {"shadow": table.detach().clone()}


def scar_select(state, table, rn: int):
    """Top r·N rows by L2 norm of change since last save."""
    rn = min(rn, table.shape[0])
    delta = torch.sum(torch.square(table - state["shadow"]), dim=-1)
    idx = _top_rows(delta, rn)
    new_shadow = state["shadow"].clone()
    new_shadow[idx.long()] = table[idx.long()]
    return idx, {"shadow": new_shadow}


# ------------------------------------------------- memory accounting -------
def tracker_memory_bytes(mode: str, num_rows: int, emb_bytes: int, r: float) -> int:
    """Table 1: tracker memory relative to the embedding table."""
    if mode == "scar":
        return num_rows * emb_bytes           # shadow copy: 100 %
    if mode == "mfu":
        return num_rows * 4                   # 4-byte counter per row
    if mode == "ssu":
        return int(num_rows * r) * 4          # r·N id slots
    return 0


# -------------------------------------- frequency/update correlation -------
def _np64(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def access_update_correlation(counts, table, table0):
    """Pearson correlation between access frequency and update L2 norm
    (paper Fig. 6 reports 0.983)."""
    c = _np64(counts)
    upd = np.linalg.norm(_np64(table) - _np64(table0), axis=-1)
    if c.std() == 0 or upd.std() == 0:
        return float("nan")
    return float(np.corrcoef(c, upd)[0, 1])
