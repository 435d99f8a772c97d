"""CPR-SSU reservoir update (dedupe + merge + random evict) on Hopper.

Replaces ``repro.kernels.ssu_dedupe.ssu_dedupe_evict`` (Pallas, one block).
At full Criteo-Kaggle width the reservoir holds over a million ids, so the
CUDA source ``csrc/ssu_dedupe.cu`` is one cooperative launch of persistent
blocks: the candidates sorted and deduped in every block, a 32-ary search
of each in the reservoir, merge-path placement written straight into the
output, and, only on overflow, a radix select of the rn-th (score,
position) key and an ordered compaction.  It takes any number of
candidates: more than ``TILE`` are sorted in tiles of ``TILED_TILE`` and
ranked across tiles in the same launch.  Its header says what bounds it.

The candidates come raw -- in any order, repeats allowed -- since the
kernel keeps each value once itself, as the reference's caller did with
``jnp.unique`` (so the card's ``ssu_update`` needs no host sync).  The
caller draws the keep-scores, so the randomness stays outside the kernel
and the host and kernel backends agree bit for bit given the same scores.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import (LAUNCHES, _host, launch_on, ref,
                                 require, stream_of)

EMPTY = ref.EMPTY
TILE = 8192         # the most candidates every block sorts at once (kTile)
TILED_TILE = 2048   # candidates a tile past that (kTiledTile)


def ssu_dedupe_evict(buf: torch.Tensor, cand: torch.Tensor,
                     scores: torch.Tensor) -> torch.Tensor:
    """Kernel launch (one).  buf (rn,) int32 sorted ascending,
    EMPTY-padded; cand (nc,) int32 in any order, repeats allowed (EMPTY
    entries are padding); scores (rn+nc,) float32 finite keep-scores (lower
    survives) -> new (rn,) sorted int32 buffer.  The checks (contiguous
    1-D int32/int32/float32 on one device, rn >= 1, rn + nc < 2**31,
    ``len(scores) == rn + nc``), allocation and launch run in the C++ host
    module."""
    require(buf.is_cuda, "ssu_dedupe_evict launches a CUDA kernel: buf must "
            "be on a CUDA device")
    out = launch_on(buf.get_device(), _host.module().ssu_dedupe_evict,
                    buf, cand, scores, stream_of(buf))
    LAUNCHES["ssu_dedupe_evict"] += 1
    return out
