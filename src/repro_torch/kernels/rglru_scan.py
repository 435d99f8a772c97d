"""The RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t on Hopper, and
its gradient.

Replaces ``repro.kernels.rglru_scan.rglru_scan`` (Pallas, forward only).
The CUDA source ``csrc/rglru_scan.cu`` keeps one sequential f32 chain per
(batch, channel), bit for bit the plain version's, and feeds it from a
ring of time tiles in shared memory that asynchronous copies keep full.
``csrc/rglru_scan_backward.cu`` walks the same chains in reverse, from a
ring of the same kind, for the gradient the reference takes through its
jnp scan, bit for bit ``ref.rglru_scan_backward``; storer warps write its
outputs out of shared memory in whole rows.  Both share
``csrc/ring.cuh``.  Each header says what bounds it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import (LAUNCHES, _build, check_launch, launch_on,
                                 require, stream_of)

_SIGS = {"rglru_scan": (_build.I, (_build.P, _build.P, _build.P, _build.I,
                                   _build.I, _build.I, _build.I, _build.P))}
_BWD_SIGS = {"rglru_scan_backward": (_build.I, (
    *(_build.P,) * 5, _build.I, _build.I, _build.I, _build.I, _build.P))}


def _check(name, x, y):
    """The kernels' shared contract on a pair of their (B, S, w) inputs."""
    require(x.is_cuda and y.device == x.device,
            f"{name} launches a CUDA kernel: its inputs must be on one CUDA "
            f"device")
    require(x.dtype in (torch.float32, torch.bfloat16) and y.dtype == x.dtype,
            f"{name}'s inputs must all be float32 or all bfloat16, got "
            f"{x.dtype}, {y.dtype}")
    require(x.dim() == 3 and y.shape == x.shape,
            f"{name}'s inputs must have one (B, S, w) shape")
    require(x.is_contiguous() and y.is_contiguous(),
            f"{name}'s inputs must be contiguous")


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Kernel launch.  a, b (B, S, w), contiguous, one dtype (f32 or bf16)
    on one CUDA device -> h (B, S, w) in a's dtype, h_0 = 0."""
    _check("rglru_scan", a, b)
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


def rglru_scan_backward(a: torch.Tensor, h: torch.Tensor,
                        dh: torch.Tensor):
    """Kernel launch of the gradient.  a (the forward's input), h (its
    output) and dh (h's gradient): (B, S, w), contiguous, one dtype on one
    CUDA device -> (da, db) in a's dtype."""
    _check("rglru_scan_backward", a, h)
    _check("rglru_scan_backward", a, dh)
    B, S, w = a.shape
    da, db = torch.empty_like(a), torch.empty_like(a)
    if a.numel() == 0:
        return da, db
    lib = _build.load("rglru_scan_backward", _BWD_SIGS)
    rc = launch_on(a.get_device(), lib.rglru_scan_backward, a.data_ptr(),
                   h.data_ptr(), dh.data_ptr(), da.data_ptr(), db.data_ptr(),
                   B, S, w, int(a.dtype == torch.bfloat16), stream_of(a))
    check_launch(rc, "rglru_scan_backward")
    LAUNCHES["rglru_scan_backward"] += 1
    return da, db
