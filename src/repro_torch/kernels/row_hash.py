"""Per-row 64-bit FNV-1a of (value row, accumulator row) bytes on Hopper.

Replaces ``repro.kernels.row_hash.row_hash`` (Pallas).  The TPU version
stages an (n, m) uint64 word matrix on the host (``ref.rows_to_words``)
and splits the 64-bit multiply; the CUDA source ``csrc/row_hash.cu``
reads the rows where they lie in device memory and multiplies natively.
Its header says what bounds it.

The result is an int64 tensor holding the uint64 bits of each hash
(PyTorch's uint64 support on CUDA is thin; the bits are what the
delta-save ledger compares).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import (LAUNCHES, _build, check_launch, ref,
                                 require, stream_of)

_SIGS = {"row_hash": (_build.I, (_build.P, _build.LL, _build.P, _build.LL,
                                 _build.LL, _build.P, _build.P))}


def row_bytes(part: torch.Tensor) -> int:
    """Bytes of one row of ``part`` (a 1-D tensor has one element per
    row)."""
    per_row = 1
    for s in part.shape[1:]:
        per_row *= s
    return per_row * part.element_size()


def row_hash(values: torch.Tensor, accs: torch.Tensor) -> torch.Tensor:
    """Kernel launch.  values (n, ...) and accs (n, ...) of any dtype,
    contiguous, on one CUDA device -> (n,) int64 FNV-1a bits.  n = 0 and
    rows of zero bytes are answered without a launch."""
    require(values.is_cuda and accs.device == values.device,
            "row_hash launches a CUDA kernel: values and accs must be on "
            "one CUDA device")
    require(values.dim() >= 1 and accs.dim() >= 1
            and values.shape[0] == accs.shape[0],
            "values and accs must have the same number of rows")
    require(values.is_contiguous() and accs.is_contiguous(),
            "row_hash reads rows in place: values and accs must be "
            "contiguous")
    n = values.shape[0]
    vb, ab = row_bytes(values), row_bytes(accs)
    out = torch.full((n,), ref.FNV_OFFSET, dtype=torch.int64,
                     device=values.device)
    if n == 0 or vb + ab == 0:
        return out
    lib = _build.load("row_hash", _SIGS)
    with torch.cuda.device(values.device):
        rc = lib.row_hash(values.data_ptr(), vb, accs.data_ptr(), ab, n,
                          out.data_ptr(), stream_of(values))
    check_launch(rc, "row_hash")
    LAUNCHES["row_hash"] += 1
    return out
