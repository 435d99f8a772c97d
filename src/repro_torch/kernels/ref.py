"""Plain PyTorch versions of the port's kernels (the allclose targets).

They mirror ``repro.kernels.ref`` (``embedding_bag``, ``tracker_select``,
``ssu_dedupe_evict``, ``row_hash``, ``flash_attention``, ``rglru_scan``)
and add the backwards the reference leaves to XLA (the embedding bag's,
attention's and the scan's, each with its gradient written out, not
taken by autograd) and the multi-table ``embedding_bags`` the fused
kernels compute.
The CPU path runs them; on the card they are only the yardstick
``chip_smoke.py`` holds each kernel against.
"""
from __future__ import annotations

import math

import torch

EMPTY = 2 ** 31 - 1          # int32 max: an unused SSU slot
# FNV-1a 64-bit constants; the offset basis 14695981039346656037 as the
# int64 with the same bits
FNV_OFFSET = 14695981039346656037 - 2 ** 64
FNV_PRIME = 1099511628211


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


def embedding_bags(tables, sparse):
    """T tables (N_t, d); sparse (B, T, hot) -> (B, T, d): the per-table
    ``embedding_bag`` stacked on dim 1."""
    return torch.stack([embedding_bag(t, sparse[:, i])
                        for i, t in enumerate(tables)], dim=1)


def embedding_bags_backward(grad_out, sparse, rows):
    """The T dense (rows[t], d) f32 gradients of ``embedding_bags`` from
    grad_out (B, T, d)."""
    return [embedding_bag_backward(grad_out[:, i], sparse[:, i], n)
            for i, n in enumerate(rows)]


def flash_attention(q, k, v, causal=True, window=0, softcap=0.0,
                    return_lse=False):
    """q: (B, Hq, Sq, hd); k/v: (B, Hkv, Skv, hd) -> (B, Hq, Sq, hd), and
    with ``return_lse`` also each row's f32 log-sum-exp (B, Hq, Sq) of the
    masked (softcapped) scores, natural log: what the backward needs.

    The (B, Hq, Sq, Skv) f32 scores are materialized after K/V are
    repeated to every query head (kv head = h // g); queries are
    right-aligned to the KV tail."""
    s, _ = _attention_scores(q, k, causal, window, softcap)
    vq = v.repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    out = torch.einsum("bhst,bhtd->bhsd", torch.softmax(s, dim=-1),
                       vq.float()).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def _attention_scores(q, k, causal, window, softcap):
    """The f32 masked scores of ``flash_attention`` (B, Hq, Sq, Skv), -1e30
    where the mask drops a key, and the softcap's tanh (None without one),
    K repeated to the query heads."""
    B, Hq, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    kq = k.repeat_interleave(Hq // Hkv, dim=1)
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), kq.float()) / math.sqrt(hd)
    t = None
    if softcap:
        t = torch.tanh(s / softcap)
        s = t * softcap
    i = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    j = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= j <= i
    if window:
        mask &= (i - j) < window
    return torch.where(mask[None, None], s, -1e30), t


def flash_attention_backward(q, k, v, out, dout, causal=True, window=0,
                             softcap=0.0, lse=None):
    """Gradients (dq, dk, dv) of ``flash_attention`` in the inputs' dtypes,
    from its output ``out`` and the output's gradient ``dout`` (both
    (B, Hq, Sq, hd)), all in f32:

        P = softmax of the masked (softcapped) scores, as the forward;
            given the forward's ``lse`` (B, Hq, Sq), P = exp(s - lse)
        dV = P^T dO,  dP = dO V^T,  D = rowsum(dO * O)
        dS = P * (dP - D)  [* (1 - tanh^2(s / cap)) with a softcap]
        dQ = dS K / sqrt(hd),  dK = dS^T Q / sqrt(hd)

    dK and dV sum over the g query heads of each KV head."""
    B, Hq, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    s, t = _attention_scores(q, k, causal, window, softcap)
    if lse is None:
        p = torch.softmax(s, dim=-1)
    else:
        p = torch.exp(s - lse.float()[..., None])
    do = dout.float()
    kq = k.float().repeat_interleave(g, dim=1)
    vq = v.float().repeat_interleave(g, dim=1)
    dv = torch.einsum("bhst,bhsd->bhtd", p, do)
    dp = torch.einsum("bhsd,bhtd->bhst", do, vq)
    delta = (do * out.float()).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    if t is not None:
        ds = ds * (1.0 - t * t)
    scale = 1.0 / math.sqrt(hd)
    dq = torch.einsum("bhst,bhtd->bhsd", ds, kq) * scale
    dk = torch.einsum("bhst,bhsd->bhtd", ds, q.float()) * scale

    def per_kv_head(x):
        return x.reshape(B, Hkv, g, Skv, hd).sum(2)

    return (dq.to(q.dtype), per_kv_head(dk).to(k.dtype),
            per_kv_head(dv).to(v.dtype))


def rglru_scan(a, b, h0=None):
    """h_t = a_t * h_{t-1} + b_t over axis 1 in f32.  a, b: (B, S, w) ->
    (B, S, w) in a's dtype."""
    B, S, w = a.shape
    h = (torch.zeros((B, w), dtype=torch.float32, device=a.device)
         if h0 is None else h0.float())
    af, bf = a.float(), b.float()
    hs = torch.empty((B, S, w), dtype=torch.float32, device=a.device)
    for t in range(S):
        h = af[:, t] * h + bf[:, t]
        hs[:, t] = h
    return hs.to(a.dtype)


def rglru_scan_backward(a, h, dh):
    """Gradients (da, db) of ``rglru_scan`` (h_0 = 0) from its output ``h``
    and the output's gradient ``dh``, in a's dtype: one reverse f32 chain

        g_t = dh_t + a_{t+1} * g_{t+1}  (g_{S+1} = 0),  db_t = g_t,
        da_t = g_t * h_{t-1}  (h_0 = 0),

    the product rounded before the sum, as the backward kernel computes
    it."""
    B, S, w = a.shape
    af, hf, dhf = a.float(), h.float(), dh.float()
    g = torch.zeros((B, w), dtype=torch.float32, device=a.device)
    da = torch.empty((B, S, w), dtype=torch.float32, device=a.device)
    db = torch.empty((B, S, w), dtype=torch.float32, device=a.device)
    for t in range(S - 1, -1, -1):
        g = dhf[:, t] if t == S - 1 else af[:, t + 1] * g + dhf[:, t]
        db[:, t] = g
        da[:, t] = g * hf[:, t - 1] if t else 0.0
    return da.to(a.dtype), db.to(a.dtype)


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
    # int32 counters: the fold wraps as the reference's int32 adds do
    folded = (counts.long() + torch.bincount(flat, minlength=N)).to(
        torch.int32).long()
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
    cand:   (nc,) int32 candidates in any order, repeats allowed (EMPTY
            entries are padding).  Their sorted ``unique``, EMPTY-padded
            back to nc, is the reference's deduped candidate list, so on
            deduped input this is the reference's function unchanged.
    scores: (rn + nc,) float keep-scores for the sorted union.

    Returns the new (rn,) sorted buffer: candidates already present are
    dropped, then the rn best (lowest-score) live entries survive, ties
    to the lower position.
    """
    rn, nc = buf.shape[0], cand.shape[0]
    uniq = torch.unique(cand)
    cand = torch.full((nc,), EMPTY, dtype=torch.int32, device=cand.device)
    cand[:uniq.shape[0]] = uniq
    cand = torch.where(torch.isin(cand, buf), EMPTY, cand)
    combined = torch.sort(torch.cat([buf, cand])).values
    score = torch.where(combined != EMPTY, scores, float("inf"))
    keep = torch.sort(score, stable=True).indices[:rn]
    return torch.sort(combined[keep]).values


def row_hash(values, accs):
    """Per-row FNV-1a over each row's value bytes then accumulator bytes
    (bit-exact target): each part zero-padded to a multiple of 8 bytes and
    read as native-endian 64-bit words, ``h = (h ^ w) * FNV_PRIME`` from
    the offset basis, in int64 arithmetic (the multiply wraps, as uint64
    does).  Returns (n,) int64 holding the uint64 bits."""
    n = values.shape[0]
    h = torch.full((n,), FNV_OFFSET, dtype=torch.int64, device=values.device)
    if n == 0:
        return h
    for part in (values, accs):
        nbytes = part.numel() * part.element_size() // n
        if nbytes == 0:
            continue
        b = part.contiguous().reshape(-1).view(torch.uint8).reshape(n, nbytes)
        words = -(-b.shape[1] // 8)
        if b.shape[1] != 8 * words or b.storage_offset() % 8:
            # zero-pad to whole words (and start 8-byte aligned, which a
            # view of int64 needs)
            padded = torch.zeros((n, 8 * words), dtype=torch.uint8,
                                 device=b.device)
            padded[:, :b.shape[1]] = b
            b = padded
        w = b.view(torch.int64)
        for i in range(words):
            h = (h ^ w[:, i]) * FNV_PRIME
    return h
