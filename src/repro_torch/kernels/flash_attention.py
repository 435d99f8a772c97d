"""Flash attention on Hopper, forward and backward: online softmax with
causal / sliding-window masks or none (bidirectional, ``causal=False``),
the gemma2 logit softcap and GQA/MQA.

Replaces ``repro.kernels.flash_attention.flash_attention`` (Pallas,
forward only).  bf16 inputs (the serving and training paths) go to the
wgmma kernel ``csrc/flash_attention_bf16.cu`` (TMA), f32 inputs to
``csrc/flash_attention.cu``, whose products run on the tensor cores in
3xTF32 (``csrc/tf32x3.cuh``: each operand split into two TF32 parts, ~21
bits a product, sums in f32).  The backward replaces the gradient the
reference takes through its jnp attention, split by dtype the same way:
``csrc/flash_attention_backward_bf16.cu`` (wgmma, TMA) and
``csrc/flash_attention_backward.cu`` (3xTF32), each spreading the causal
band's dK/dV work over the card in runs summed in order.  The forward
hands each row's log-sum-exp to the backward on request
(``return_lse``), so the backward does not recompute Q.K^T for it.  Each
source says what bounds it; all walk only the key tiles the mask touches.

The kernel layout is the reference's: q (B, Hq, Sq, hd), k/v (B, Hkv,
Skv, hd), queries right-aligned to the KV tail.  The kernel addresses each
tensor by its strides, so ``ops.flash_attention`` hands it transposed
views of the model's (B, S, H, hd) tensors without a copy, and the output
keeps q's memory layout.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import (LAUNCHES, _build, check_launch, launch_on,
                                 require, stream_of)

# head dim 80 (HuBERT) has bf16 kernels of its own, in exact 80-wide tiles
HEAD_DIMS = (32, 64, 80, 128, 256)
# (q, k, v, o, lse, strides, B, Hq, Hkv, Sq, Skv, hd, scale, causal,
#  window, softcap, stream) -> CUDA error code; by dtype: (library,
#  function)
_ARGS = (*(_build.P,) * 6, *(_build.I,) * 6, _build.F, _build.I, _build.I,
         _build.F, _build.P)
_KERNELS = {torch.float32: ("flash_attention", "flash_attention_fwd"),
            torch.bfloat16: ("flash_attention_bf16", "flash_attention_bf16_fwd")}
# the backward by dtype: (library, function).  The function takes (q, k,
# v, o, dout, lse, dq, dk, dv, scratch, strides, B, Hq, Hkv, Sq, Skv, hd,
# scale, causal, window, softcap, stream); ``<function>_scratch`` gives its
# scratch's size from (B, Hq, Hkv, Sq, Skv, hd, causal, window), in f32
# values
_BWD_KERNELS = {
    torch.float32: ("flash_attention_backward", "flash_attention_bwd"),
    torch.bfloat16: ("flash_attention_backward_bf16",
                     "flash_attention_bf16_bwd")}
_BWD_ARGS = (*(_build.P,) * 11, *(_build.I,) * 6, _build.F, _build.I,
             _build.I, _build.F, _build.P)
_STRIDES12 = _build.LL * 12
_STRIDES24 = _build.LL * 24
# the loaded ctypes functions by dtype: resolved once per process, so a
# call takes no lock
_FWD_FNS: dict = {}
_BWD_FNS: dict = {}


def _aligned(t: torch.Tensor) -> bool:
    """Contiguous head dim; pointer and (batch, head, seq) strides in
    whole 16-byte units, as the f32 kernel's vector loads and the bf16
    kernel's TMA copies need."""
    b, h, s, d = t.stride()
    unit = 16 // t.element_size()          # elements in 16 bytes
    return (d == 1 and t.data_ptr() % 16 == 0
            and (b % unit | h % unit | s % unit) == 0)


def _check(q, k, v, window, softcap):
    """The kernels' shared contract on q, k, v and the mask options (each
    message is formatted only when its check fails)."""
    require(q.is_cuda and k.device == q.device and v.device == q.device,
            "flash_attention launches a CUDA kernel: q, k and v must be on "
            "one CUDA device")
    if not (q.dtype in (torch.float32, torch.bfloat16)
            and k.dtype == q.dtype and v.dtype == q.dtype):
        raise ValueError(f"q, k, v must all be float32 or all bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    require(q.dim() == 4 and k.dim() == 4 and v.shape == k.shape,
            "q must be (B, Hq, Sq, hd) and k, v (B, Hkv, Skv, hd)")
    B, Hq, Sq, hd = q.shape
    _, Hkv, Skv, _ = k.shape
    require(k.shape[0] == B and k.shape[3] == hd,
            "q, k and v must share batch and head dim")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if not (Hkv > 0 and Hq % Hkv == 0):
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    require(Skv >= Sq, "queries are right-aligned to the KV tail: Skv must "
            "be >= Sq")
    require(window >= 0 and softcap >= 0, "window and softcap must be >= 0")


def _forward_fn(dtype):
    """The dtype's forward launcher (built and loaded at first use)."""
    fn = _FWD_FNS.get(dtype)
    if fn is None:
        name, fname = _KERNELS[dtype]
        fn = getattr(_build.load(name, {fname: (_build.I, _ARGS)}), fname)
        _FWD_FNS[dtype] = fn
    return fn


def _forward(q, k, v, out, lse, causal, window, softcap) -> int:
    """One launch of the dtype's forward kernel: the output into ``out``
    and, given ``lse``, each row's log-sum-exp into it; with ``out`` None
    the log-sum-exp alone.  Returns the CUDA error code."""
    B, Hq, Sq, hd = q.shape
    _, Hkv, Skv, _ = k.shape
    o = q if out is None else out          # no output: its strides unread
    strides = _STRIDES12(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                         *o.stride()[:3])
    return launch_on(q.get_device(), _forward_fn(q.dtype), q.data_ptr(),
                     k.data_ptr(), v.data_ptr(),
                     None if out is None else out.data_ptr(),
                     None if lse is None else lse.data_ptr(), strides, B, Hq,
                     Hkv, Sq, Skv, hd, 1.0 / math.sqrt(hd), int(causal),
                     int(window), float(softcap), stream_of(q))


def _backward_fns(dtype):
    """The dtype's backward launcher and its scratch-size function (built
    and loaded at first use)."""
    fns = _BWD_FNS.get(dtype)
    if fns is None:
        name, fn = _BWD_KERNELS[dtype]
        lib = _build.load(name, {fn: (_build.I, _BWD_ARGS),
                                 fn + "_scratch": (_build.LL,
                                                   (_build.I,) * 8)})
        fns = _BWD_FNS[dtype] = (getattr(lib, fn),
                                 getattr(lib, fn + "_scratch"))
    return fns


def _rows(q: torch.Tensor) -> torch.Tensor:
    """An f32 value per query row, (B, Hq, Sq)."""
    return torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, return_lse: bool = False):
    """Kernel launch.  q (B, Hq, Sq, hd), k/v (B, Hkv, Skv, hd), one dtype
    (f32 or bf16) on one CUDA device, hd in ``HEAD_DIMS``, Hq a multiple
    of Hkv, Skv >= Sq -> (B, Hq, Sq, hd) in q's dtype and strides; with
    ``return_lse`` the pair (output, each row's f32 log-sum-exp (B, Hq,
    Sq), natural log), which ``flash_attention_backward`` takes."""
    _check(q, k, v, window, softcap)
    out = torch.empty_like(q)              # q's strides (dense views)
    lse = _rows(q) if return_lse else None
    require(all(_aligned(t) for t in (q, k, v, out)),
            "q, k, v need a contiguous head dim and 16-byte aligned "
            "pointers and strides")
    if q.numel():
        check_launch(_forward(q, k, v, out, lse, causal, window, softcap),
                     "flash_attention")
        LAUNCHES["flash_attention"] += 1
    return (out, lse) if return_lse else out


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             dout: torch.Tensor, causal: bool = True,
                             window: int = 0, softcap: float = 0.0,
                             lse: torch.Tensor = None):
    """Kernel launch of the backward: the forward's q, k, v and output
    ``out``, and the output's gradient ``dout`` (like q, same dtype) ->
    (dq, dk, dv) in the inputs' dtype and strides.  The forward's contract
    holds for every tensor.  ``lse``: the forward's log-sum-exp
    (``flash_attention(..., return_lse=True)``); without it the call
    computes it first with the forward kernel (no output written).  One
    call, one count: the rows' D, dK/dV by runs of a key tile's steps
    (runs summed in order where a key tile took several), dQ by query
    tile; one scratch allocation."""
    _check(q, k, v, window, softcap)
    require(out.shape == q.shape and dout.shape == q.shape
            and out.dtype == q.dtype and dout.dtype == q.dtype
            and out.device == q.device and dout.device == q.device,
            "out and dout must be like q")
    B, Hq, Sq, hd = q.shape
    _, Hkv, Skv, _ = k.shape
    if lse is not None:
        require(lse.shape == (B, Hq, Sq) and lse.dtype == torch.float32
                and lse.device == q.device,
                "lse must be the forward's f32 (B, Hq, Sq) log-sum-exp")
        lse = lse.contiguous()
    require(all(_aligned(t) for t in (q, k, v, out, dout)),
            "q, k, v, out and dout need a contiguous head dim and 16-byte "
            "aligned pointers and strides")
    # like q, k, v: their strides where those are dense, else contiguous;
    # aligned either way
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    strides = _STRIDES24(*[s for t in (q, k, v, out, dout, dq, dk, dv)
                           for s in t.stride()[:3]])
    fn, scratch_size = _backward_fns(q.dtype)
    n = scratch_size(B, Hq, Hkv, Sq, Skv, hd, int(causal), int(window))
    scratch = torch.empty(n + (0 if lse is not None else B * Hq * Sq),
                          dtype=torch.float32, device=q.device)
    if lse is None:
        lse = scratch[n:]
        check_launch(_forward(q, k, v, None, lse, causal, window, softcap),
                     "flash_attention_backward")
    rc = launch_on(q.get_device(), fn, q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                   lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                   dv.data_ptr(), scratch.data_ptr(), strides, B, Hq, Hkv,
                   Sq, Skv, hd, 1.0 / math.sqrt(hd), int(causal),
                   int(window), float(softcap), stream_of(q))
    check_launch(rc, "flash_attention_backward")
    LAUNCHES["flash_attention_backward"] += 1
    return dq, dk, dv
