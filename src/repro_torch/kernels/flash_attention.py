"""Flash attention on Hopper, forward and backward: online softmax with
causal / sliding-window masks, the gemma2 logit softcap and GQA/MQA.

Replaces ``repro.kernels.flash_attention.flash_attention`` (Pallas,
forward only).  bf16 inputs (the serving and training paths) go to the
tensor-core kernel ``csrc/flash_attention_bf16.cu`` (wgmma, TMA), f32
inputs to the FMA kernel ``csrc/flash_attention.cu``, which keeps f32
products exact.  The backward (``csrc/flash_attention_backward.cu``, f32
FMAs for either dtype) replaces the gradient the reference takes through
its jnp attention.  Each source says what bounds it; all walk only the
key tiles the mask touches.

The kernel layout is the reference's: q (B, Hq, Sq, hd), k/v (B, Hkv,
Skv, hd), queries right-aligned to the KV tail.  The kernel addresses each
tensor by its strides, so ``ops.flash_attention`` hands it transposed
views of the model's (B, S, H, hd) tensors without a copy, and the output
keeps q's memory layout.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import (LAUNCHES, _build, check_launch, require,
                                 stream_of)

HEAD_DIMS = (32, 64, 128, 256)
# (q, k, v, o, strides, B, Hq, Hkv, Sq, Skv, hd, scale, causal, window,
#  softcap, stream) -> CUDA error code; by dtype: (library, function)
_ARGS = (_build.P, _build.P, _build.P, _build.P, _build.P,
         _build.I, _build.I, _build.I, _build.I, _build.I, _build.I,
         _build.F, _build.I, _build.I, _build.F, _build.P)
_KERNELS = {torch.float32: ("flash_attention", "flash_attention_fwd"),
            torch.bfloat16: ("flash_attention_bf16", "flash_attention_bf16_fwd")}
# (q, k, v, o, dout, dq, dk, dv, lse, delta, strides, B, Hq, Hkv, Sq, Skv,
#  hd, scale, causal, window, softcap, bf16, stream) -> CUDA error code
_BWD_SIGS = {"flash_attention_bwd": (_build.I, (
    *(_build.P,) * 11, *(_build.I,) * 6, _build.F, _build.I, _build.I,
    _build.F, _build.I, _build.P))}


def _aligned(t: torch.Tensor) -> bool:
    """Contiguous head dim; pointer and (batch, head, seq) strides in
    whole 16-byte units, as the f32 kernel's vector loads and the bf16
    kernel's TMA copies need."""
    size = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s * size % 16 == 0 for s in t.stride()[:3]))


def _check(q, k, v, window, softcap):
    """The kernels' shared contract on q, k, v and the mask options."""
    require(q.is_cuda and k.device == q.device and v.device == q.device,
            "flash_attention launches a CUDA kernel: q, k and v must be on "
            "one CUDA device")
    require(q.dtype in (torch.float32, torch.bfloat16)
            and k.dtype == q.dtype and v.dtype == q.dtype,
            f"q, k, v must all be float32 or all bfloat16, got {q.dtype}, "
            f"{k.dtype}, {v.dtype}")
    require(q.dim() == 4 and k.dim() == 4 and v.shape == k.shape,
            "q must be (B, Hq, Sq, hd) and k, v (B, Hkv, Skv, hd)")
    B, Hq, Sq, hd = q.shape
    _, Hkv, Skv, _ = k.shape
    require(k.shape[0] == B and k.shape[3] == hd,
            "q, k and v must share batch and head dim")
    require(hd in HEAD_DIMS, f"head dim {hd} not in {HEAD_DIMS}")
    require(Hkv > 0 and Hq % Hkv == 0,
            f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    require(Skv >= Sq, "queries are right-aligned to the KV tail: Skv must "
            "be >= Sq")
    require(window >= 0 and softcap >= 0, "window and softcap must be >= 0")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """Kernel launch.  q (B, Hq, Sq, hd), k/v (B, Hkv, Skv, hd), one dtype
    (f32 or bf16) on one CUDA device, hd in ``HEAD_DIMS``, Hq a multiple
    of Hkv, Skv >= Sq -> (B, Hq, Sq, hd) in q's dtype and strides."""
    _check(q, k, v, window, softcap)
    B, Hq, Sq, hd = q.shape
    _, Hkv, Skv, _ = k.shape
    out = torch.empty_like(q)              # q's strides (dense views)
    require(all(_aligned(t) for t in (q, k, v, out)),
            "q, k, v need a contiguous head dim and 16-byte aligned "
            "pointers and strides")
    if q.numel() == 0:
        return out
    strides = (_build.LL * 12)(*(s for t in (q, k, v, out)
                                 for s in t.stride()[:3]))
    name, fn = _KERNELS[q.dtype]
    fn = getattr(_build.load(name, {fn: (_build.I, _ARGS)}), fn)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                strides, B, Hq, Hkv, Sq, Skv, hd, 1.0 / math.sqrt(hd),
                int(causal), int(window), float(softcap), stream_of(q))
    check_launch(rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             dout: torch.Tensor, causal: bool = True,
                             window: int = 0, softcap: float = 0.0):
    """Kernel launch of the backward: the forward's q, k, v and output
    ``out``, and the output's gradient ``dout`` (like q, same dtype) ->
    (dq, dk, dv) in the inputs' dtype and strides.  The forward's contract
    holds for every tensor.  One call, one count: three kernels (the rows'
    log-sum-exp and D, then dK/dV by key tile, then dQ by query tile)."""
    _check(q, k, v, window, softcap)
    require(out.shape == q.shape and dout.shape == q.shape
            and out.dtype == q.dtype and dout.dtype == q.dtype
            and out.device == q.device and dout.device == q.device,
            "out and dout must be like q")
    B, Hq, Sq, hd = q.shape
    _, Hkv, Skv, _ = k.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    require(all(_aligned(t) for t in (q, k, v, out, dout, dq, dk, dv)),
            "q, k, v, out and dout need a contiguous head dim and 16-byte "
            "aligned pointers and strides")
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    strides = (_build.LL * 24)(*(s for t in (q, k, v, out, dout, dq, dk, dv)
                                 for s in t.stride()[:3]))
    lib = _build.load("flash_attention_backward", _BWD_SIGS)
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), strides, B, Hq, Hkv, Sq, Skv,
            hd, 1.0 / math.sqrt(hd), int(causal), int(window),
            float(softcap), int(q.dtype == torch.bfloat16), stream_of(q))
    check_launch(rc, "flash_attention_backward")
    LAUNCHES["flash_attention_backward"] += 1
    return dq, dk, dv
