"""CPR-SSU reservoir update (dedupe + merge + random evict) on Hopper.

Replaces ``repro.kernels.ssu_dedupe.ssu_dedupe_evict`` (Pallas, one block).
At full Criteo-Kaggle width the reservoir holds over a million ids, so the
CUDA source ``csrc/ssu_dedupe.cu`` is multi-block and exact: binary-search
membership, merge-path ranks, a radix select of the rn-th (score,
position) key, and an ordered compaction.  Its header says what bounds it.

The caller keeps the ``unique`` of the candidates and the draw of the
keep-scores, so the randomness stays outside the kernel and the host and
kernel backends agree bit for bit given the same scores.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import (LAUNCHES, _build, check_launch, ref,
                                 require, stream_of)

EMPTY = ref.EMPTY
MAX_CAND = 8192              # candidates sorted in one block's shared memory

_SIGS = {
    "ssu_scratch_words": (_build.LL, (_build.I, _build.I)),
    "ssu_dedupe_evict": (_build.I, (_build.P, _build.P, _build.P, _build.P,
                                    _build.P, _build.I, _build.I, _build.P)),
}


def ssu_dedupe_evict(buf: torch.Tensor, cand: torch.Tensor,
                     scores: torch.Tensor) -> torch.Tensor:
    """Kernel launch.  buf (rn,) int32 sorted ascending, EMPTY-padded;
    cand (nc,) int32 (EMPTY-padded); scores (rn+nc,) float32 finite
    keep-scores (lower survives) -> new (rn,) sorted int32 buffer."""
    require(buf.is_cuda, "ssu_dedupe_evict launches a CUDA kernel: buf must "
            "be on a CUDA device")
    require(buf.dtype == torch.int32 and cand.dtype == torch.int32,
            "buf and cand must be int32")
    require(scores.dtype == torch.float32, "scores must be float32")
    require(all(t.dim() == 1 and t.is_contiguous() and t.device == buf.device
                for t in (buf, cand, scores)),
            "buf, cand and scores must be contiguous 1-D tensors on one device")
    rn, nc = buf.shape[0], cand.shape[0]
    require(rn >= 1, "the reservoir must have at least one slot")
    require(nc <= MAX_CAND, f"at most {MAX_CAND} candidates, got {nc}")
    require(scores.shape[0] == rn + nc, "scores must have rn + nc entries")
    require(rn + nc < 2 ** 31, "reservoir too large for int32 positions")
    lib = _build.load("ssu_dedupe", _SIGS)
    scratch = torch.empty(lib.ssu_scratch_words(rn, nc), dtype=torch.int32,
                          device=buf.device)
    out = torch.empty(rn, dtype=torch.int32, device=buf.device)
    with torch.cuda.device(buf.device):
        rc = lib.ssu_dedupe_evict(buf.data_ptr(), cand.data_ptr(),
                                  scores.data_ptr(), out.data_ptr(),
                                  scratch.data_ptr(), rn, nc,
                                  stream_of(buf))
    check_launch(rc, "ssu_dedupe_evict")
    LAUNCHES["ssu_dedupe_evict"] += 1
    return out
