"""SSU updates with more candidates than one tile, on the CPU.

On the card, ``ssu_dedupe_evict`` sorts more than ``TILE`` (8,192)
candidates in tiles of ``TILED_TILE`` (2,048) and ranks the live ones
across tiles in the same launch (``csrc/ssu_dedupe.cu``, phases T1-T3).
Held here: the port's ``ssu_update`` (host and kernel backends; the kernel backend runs the
plain version on the CPU) walks the reference's reservoir bit for bit at
8,193 and 16,384 candidates given the same keep-scores; and a numpy
emulation of the tiled phases -- tile sort and dedupe, the cross-tile
duplicate marks, the reservoir lookups, the ranks summed over tiles, the
per-slice placement and the overflow keep -- equals the plain version at
up to 65,536 candidates, with values repeated across tiles.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import trackers as rtrk
from repro.kernels import ref as rref
from repro_torch.core import trackers as ttrk
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ssu_dedupe import TILE, TILED_TILE

EMPTY = ref.EMPTY
SLOTS = 4          # consecutive output slots a thread writes (kSlots)


# ------------------------------------------------------------ ssu_update ----
@pytest.mark.parametrize("backend", ["host", "kernel"])
@pytest.mark.parametrize("nc", [TILE + 1, 2 * TILE])
def test_ssu_update_many_candidates_matches_reference(nc, backend):
    """Period 2 over 2 * nc ids from a small space (repeats inside the
    batch and against the reservoir), three rounds, the reference's
    keep-scores replayed into the port: the second round overflows."""
    rn, period = 6000, 2
    rs = rtrk.ssu_init(rn, seed=5)
    ts = ttrk.ssu_init(rn, seed=5, device="cpu")
    rng = np.random.default_rng(nc)
    for k in range(3):
        idx = rng.integers(0, 40_000, size=(period * nc,)).astype(np.int32)
        _, sub = jax.random.split(rs["key"])
        scores = np.asarray(jax.random.uniform(sub, (rn + nc,)))
        rs = rtrk.ssu_update(rs, jnp.asarray(idx), period, backend="host")
        ts = ttrk.ssu_update(ts, torch.tensor(idx), period, backend=backend,
                             scores=torch.tensor(scores))
        np.testing.assert_array_equal(ts["buf"].numpy(), np.asarray(rs["buf"]),
                                      err_msg=f"round {k}")
    assert (ts["buf"] != EMPTY).sum() == rn              # it overflowed


# ------------------------------------------- the tiled phases, emulated ----
def _score_keys(scores):
    """Order-preserving uint32 bits of the keep-scores, -0 tying +0."""
    f = np.where(scores == 0, np.float32(0), scores).astype(np.float32)
    u = f.view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def _tiled_ssu(buf, cand, scores, tile=TILED_TILE, grid=7):
    """The tiled kernel's phases in numpy, as its blocks compute them."""
    rn, nc = buf.size, cand.size
    nt = -(-nc // tile)
    # T1: each tile sorted, each value once, EMPTY dropped
    tval = np.full((nt, tile), EMPTY, np.int32)
    tcount = np.zeros(nt, np.int64)
    for t in range(nt):
        part = cand[t * tile:(t + 1) * tile]
        srt = np.sort(np.concatenate(
            [part, np.full(tile - part.size, EMPTY, np.int32)]))
        keep = (srt != EMPTY) & np.r_[True, srt[1:] != srt[:-1]]
        tcount[t] = keep.sum()
        tval[t, :tcount[t]] = srt[keep]
    lb = int(np.searchsorted(buf, EMPTY))          # live reservoir ids
    # T2: values an earlier tile holds; each value's lower bound in buf
    tdup = np.zeros((nt, tile), bool)
    tpos = np.full((nt, tile), -1, np.int64)
    for t in range(nt):
        n, cur = tcount[t], tval[t, :tcount[t]]
        for s in range(t):
            u = tval[s, :tcount[s]]
            p = np.searchsorted(cur, u)
            hit = p < n
            hit[hit] = cur[p[hit]] == u[hit]
            tdup[t, p[hit]] = True
        p = np.searchsorted(buf, cur)
        present = (p < rn) & (buf[np.minimum(p, rn - 1)] == cur)
        tpos[t, :n] = np.where(present, -1, p)
    # T3: each tile's live values, ranked by the live values of all tiles
    live = np.full(nc, -1, np.int64)
    mpos = np.full(nc, -1, np.int64)
    lc = 0
    alive = [~tdup[t, :tcount[t]] & (tpos[t, :tcount[t]] >= 0)
             for t in range(nt)]
    for t in range(nt):
        vals = tval[t, :tcount[t]][alive[t]]
        pos = tpos[t, :tcount[t]][alive[t]]
        mt = vals.size
        lc += mt
        diff = np.zeros(mt, np.int64)
        for s in range(nt):
            if s != t:
                p = np.searchsorted(vals, tval[s, :tcount[s]][alive[s]])
                np.add.at(diff, p[p < mt], 1)
        rank = np.arange(mt) + np.cumsum(diff)
        assert (live[rank] == -1).all()            # one value a rank
        live[rank], mpos[rank] = vals, rank + pos
    live, mpos = live[:lc], mpos[:lc]
    assert (live >= 0).all() and (np.diff(live) > 0).all()

    def union(o0, o1):
        """Slots [o0, o1) of the sorted union, as a block writes them:
        the candidates placed there, else the reservoir's next id."""
        c_lo = int(np.searchsorted(mpos, o0))
        c_hi = int(np.searchsorted(mpos, o1))
        out = []
        for base in range(o0, o1, SLOTS):
            c = c_lo + int(np.searchsorted(mpos[c_lo:c_hi], base))
            q = base - c
            b = [int(buf[q + e]) if q + e < lb else EMPTY
                 for e in range(SLOTS)]
            used = 0
            for e in range(min(SLOTS, o1 - base)):
                if c < c_hi and mpos[c] == base + e:
                    out.append(int(live[c]))
                    c += 1
                else:
                    out.append(b[used])
                    used += 1
        return out

    def blocks(n, per):
        """Each block's slice of [0, n), ``per`` slots a block."""
        return sum((union(min(b * per, n), min((b + 1) * per, n))
                    for b in range(grid)), [])

    n_live = lb + lc
    if n_live <= rn:                                # W: combined[:rn]
        chunk = -(-rn // (SLOTS * grid)) * SLOTS
        return np.array(blocks(rn, chunk), np.int32)
    # O: the rn smallest (key, position) of [0, n_live), in position order
    combined = np.array(blocks(n_live, -(-n_live // grid)), np.int64)
    keys = _score_keys(scores[:n_live])
    T = np.sort(keys)[rn - 1]
    need = rn - int((keys < T).sum())
    kept = (keys < T) | ((keys == T) & (np.cumsum(keys == T) <= need))
    return combined[kept].astype(np.int32)


def _case(rn, nc, live, kind, seed):
    rng = np.random.default_rng(seed)
    buf = np.full(rn, EMPTY, np.int32)
    buf[:live] = np.sort(rng.choice(10 * rn, size=live, replace=False))
    if kind == "all_present":
        cand = rng.choice(buf[:live], size=nc).astype(np.int32)
    else:
        cand = rng.choice(10 * rn, size=nc).astype(np.int32)
        if live:
            cand[: nc // 4] = rng.choice(buf[:live], size=nc // 4)
        # the second half repeats the first: values repeat across tiles
        cand[nc // 2:] = rng.choice(cand[:max(nc // 2, 1)], size=nc - nc // 2)
    if kind == "unique":               # sorted unique, EMPTY-padded
        u = np.unique(cand)
        cand = np.full(nc, EMPTY, np.int32)
        cand[:u.size] = u
    scores = rng.uniform(size=rn + nc).astype(np.float32)
    if kind == "tied":
        scores = np.floor(scores * 8) / 8
    if kind == "signed_zero":
        scores = np.where(rng.uniform(size=rn + nc) < 0.5, np.float32(-0.0),
                          np.float32(0.0)).astype(np.float32)
        scores[::5] = 0.5
    return buf, cand, scores.astype(np.float32)


@pytest.mark.parametrize("rn,nc,live,kind,tile", [
    (3000, TILE + 1, 1000, "raw", TILED_TILE),      # 5 tiles, no overflow
    (3000, 2 * TILE, 3000, "raw", TILED_TILE),      # overflow
    (3000, 2 * TILE, 3000, "unique", TILED_TILE),   # tiles of EMPTY padding
    (2000, 2 * TILE, 2000, "signed_zero", TILED_TILE),
    (5000, 8 * TILE, 2000, "raw", TILED_TILE),      # 32 tiles
    (5000, 8 * TILE, 5000, "tied", TILED_TILE),
    (3000, 2 * TILE, 1000, "raw", TILE),            # two 8,192-tiles
    (500, 1000, 100, "raw", 64),                    # 16 small tiles
    (500, 1000, 500, "raw", 64),
    (300, 2000, 300, "all_present", 64),
    (1, 300, 0, "raw", 64),                         # one slot
])
def test_tiled_emulation_matches_plain_version(rn, nc, live, kind, tile):
    buf, cand, scores = _case(rn, nc, live, kind, seed=rn + nc + live)
    want = ops.ssu_dedupe_evict(torch.tensor(buf), torch.tensor(cand),
                                torch.tensor(scores)).numpy()
    np.testing.assert_array_equal(_tiled_ssu(buf, cand, scores, tile), want)


@pytest.mark.parametrize("rn,nc,live,kind", [
    (2000, TILE + 1, 500, "raw"), (2000, TILE + 1, 2000, "raw"),
    (1500, 2 * TILE, 1500, "tied")])
def test_plain_version_many_candidates_matches_reference(rn, nc, live, kind):
    """The port's plain version on raw candidates against the reference's
    numpy version on their unique, EMPTY-padded form."""
    buf, cand, scores = _case(rn, nc, live, kind, seed=rn * 7 + nc)
    u = np.unique(cand)
    dedup = np.full(nc, EMPTY, np.int32)
    dedup[:u.size] = u
    got = ops.ssu_dedupe_evict(torch.tensor(buf), torch.tensor(cand),
                               torch.tensor(scores)).numpy()
    np.testing.assert_array_equal(got, rref.ssu_dedupe_evict(buf, dedup,
                                                             scores))
