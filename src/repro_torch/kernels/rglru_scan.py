"""The RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t on Hopper.

Replaces ``repro.kernels.rglru_scan.rglru_scan`` (Pallas, forward only).
The CUDA source ``csrc/rglru_scan.cu`` keeps one sequential f32 chain per
(batch, channel), bit for bit the plain version's, and feeds it from a
ring of time tiles in shared memory that asynchronous copies keep full;
its header says what bounds it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import (LAUNCHES, _build, check_launch, launch_on,
                                 require, stream_of)

_SIGS = {"rglru_scan": (_build.I, (_build.P, _build.P, _build.P, _build.I,
                                   _build.I, _build.I, _build.I, _build.P))}


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Kernel launch.  a, b (B, S, w), contiguous, one dtype (f32 or bf16)
    on one CUDA device -> h (B, S, w) in a's dtype, h_0 = 0."""
    require(a.is_cuda and b.device == a.device,
            "rglru_scan launches a CUDA kernel: a and b must be on one "
            "CUDA device")
    require(a.dtype in (torch.float32, torch.bfloat16) and b.dtype == a.dtype,
            f"a and b must both be float32 or both bfloat16, got {a.dtype}, "
            f"{b.dtype}")
    require(a.dim() == 3 and b.shape == a.shape,
            "a and b must have one (B, S, w) shape")
    require(a.is_contiguous() and b.is_contiguous(),
            "a and b must be contiguous")
    B, S, w = a.shape
    h = torch.empty_like(a)
    if h.numel() == 0:
        return h
    lib = _build.load("rglru_scan", _SIGS)
    rc = launch_on(a.get_device(), lib.rglru_scan, a.data_ptr(), b.data_ptr(),
                   h.data_ptr(), B, S, w, int(a.dtype == torch.bfloat16),
                   stream_of(a))
    check_launch(rc, "rglru_scan")
    LAUNCHES["rglru_scan"] += 1
    return h
