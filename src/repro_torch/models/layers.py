"""Core layers of the language models: norms, RoPE and M-RoPE, GQA
attention, MLPs.

The port of ``repro.models.layers``: ``init_*`` return dicts of tensors
with the reference's names and shapes, ``apply`` functions are plain.
Full-sequence attention always goes through ``kernels.ops.flash_attention``
(the CUDA kernels, forward and backward, for CUDA tensors; the plain
versions for CPU ones), so there is no ``use_flash`` switch; the decode
step attends over its cache with plain tensor code, as the reference does.

Queries and keys are rotated by the positions given (any values: (B, S)
for RoPE, the (3, B, S) t/h/w streams for Qwen2-VL's M-RoPE), and
attention is causal or bidirectional (HuBERT) as the config says.  The
causal mask goes by index, query i seeing key j <= i, whatever the
positions: the reference's kernel path (``use_flash=True``) and Qwen2-VL
mask so; the reference's jnp path masks by the first position stream
instead, which differs only where positions are not ``arange(S)``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LOCAL_ATTN
from repro_torch.kernels import ops


# --------------------------------------------------------------------------
# initializers
# --------------------------------------------------------------------------
def dense_init(generator, shape, in_axis=0, device=None):
    """Uniform in +-1/sqrt(fan_in), f32 (the reference's ``dense_init``)."""
    fan_in = shape[in_axis] if isinstance(in_axis, int) else 1
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return u.mul_(2 * scale).sub_(scale)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------
def init_norm(d, kind="rmsnorm", device=None):
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def apply_norm(p, x, eps=1e-6):
    """In f32, cast back to x's dtype (gemma's 1+scale folded into init)."""
    xf = x.float()
    if "bias" in p:  # layernorm
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:  # rmsnorm
        ms = xf.square().mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * p["scale"]
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def _rotate(x, ang):
    """x (..., S, H, hd) rotated by the f32 angles ``ang`` (..., S, 1,
    hd/2): split halves (not interleaved pairs)."""
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions broadcastable to (..., S).  Angles in
    f32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)        # (hd/2,)
    ang = positions[..., None].float() * freqs              # (..., S, hd/2)
    return _rotate(x, ang[..., None, :])


def apply_mrope(x, positions, theta: float, sections=(16, 24, 24)):
    """Qwen2-VL's multimodal RoPE.  x: (..., S, H, hd); positions (3, ...,
    S), the t, h and w streams.  ``sections`` count the half-dim channels
    each stream rotates, in order, and sum to hd / 2."""
    hd = x.shape[-1]
    assert sum(sections) == hd // 2, (sections, hd)
    freqs = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    pos = positions.float()
    parts, lo = [], 0
    for stream, n in enumerate(sections):   # each channel's own stream
        parts.append(pos[stream][..., None] * freqs[lo:lo + n])
        lo += n
    return _rotate(x, torch.cat(parts, dim=-1)[..., None, :])


def mrope_sections(head_dim: int):
    """The (t, h, w) half-dim channel split of Qwen2-VL (head dim 128 ->
    16 / 24 / 24)."""
    half = head_dim // 2
    t = half // 4
    rest = half - t
    return (t, rest // 2, rest - rest // 2)


def _position_rotary(q, k, positions, cfg):
    """q and k rotated by ``positions`` as the config says: M-RoPE over
    (3, B, S) streams, RoPE over (B, S), or not at all."""
    if cfg.mrope:
        sections = mrope_sections(cfg.head_dim)
        return (apply_mrope(q, positions, cfg.rope_theta, sections),
                apply_mrope(k, positions, cfg.rope_theta, sections))
    if cfg.rope_theta > 0:
        return (apply_rope(q, positions, cfg.rope_theta),
                apply_rope(k, positions, cfg.rope_theta))
    return q, k


# --------------------------------------------------------------------------
# attention (GQA, optional sliding window / softcap / KV cache)
# --------------------------------------------------------------------------
def init_attention(generator, cfg, device=None):
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    p = {"wq": dense_init(generator, (d, nq * hd), device=device),
         "wk": dense_init(generator, (d, nkv * hd), device=device),
         "wv": dense_init(generator, (d, nkv * hd), device=device),
         "wo": dense_init(generator, (nq * hd, d), device=device)}
    if cfg.qkv_bias:     # Qwen: zero biases, as the reference starts them
        for name, n in (("bq", nq), ("bk", nkv), ("bv", nkv)):
            p[name] = torch.zeros((n * hd,), dtype=torch.float32,
                                  device=device)
    return p


def _softcap(x, cap):
    return torch.tanh(x / cap) * cap if cap else x


def _project_qkv(p, x, cfg):
    """q, k, v in (B, S, heads, hd), the biases (if any) added in x's dtype
    before the reshape and RoPE (prefill and decode alike)."""
    B, S, _ = x.shape
    out = []
    for w, b, heads in (("wq", "bq", cfg.num_heads),
                        ("wk", "bk", cfg.num_kv_heads),
                        ("wv", "bv", cfg.num_kv_heads)):
        y = x @ p[w].to(x.dtype)
        if cfg.qkv_bias:
            y = y + p[b].to(x.dtype)
        out.append(y.reshape(B, S, heads, cfg.head_dim))
    return tuple(out)


def _sdpa(q, k, v, mask, softcap=0.0):
    """q: (B,S,Hq,hd) k/v: (B,T,Hkv,hd); GQA via head grouping; mask
    (B,S,T).  Plain f32 attention (the decode step's)."""
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    qf = q.float().reshape(B, S, Hkv, g, hd)
    logits = torch.einsum("bskgd,btkd->bkgst", qf, k.float()) / math.sqrt(hd)
    logits = _softcap(logits, softcap)
    logits = torch.where(mask[:, None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(B, S, Hq, hd).to(q.dtype)


def attention_forward(p, x, cfg, kind, positions):
    """Full-sequence attention (train / prefill) through the flash kernel:
    causal by index, or bidirectional for an encoder (``cfg.causal``
    False).  kind: "attn" (global) or "local" (sliding window).
    positions: (B, S) or (1, S), (3, B, S) under M-RoPE (as
    ``transformer.embed_inputs`` gives them)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg)
    q, k = _position_rotary(q, k, positions, cfg)
    window = cfg.sliding_window if kind == LOCAL_ATTN else 0
    out = ops.flash_attention(q, k, v, causal=cfg.causal, window=window,
                              softcap=cfg.attn_softcap)
    return out.reshape(B, S, -1) @ p["wo"].to(x.dtype)


def init_kv_cache(cfg, kind, batch, max_len, dtype, device=None):
    """KV cache for one attention layer.  Local layers use a ring buffer of
    window size; global layers a full-length buffer.  With
    ``cfg.kv_cache_dtype == "int8"`` keys/values are stored quantized with a
    per-(token, kv-head) bf16 scale."""
    W = (min(cfg.sliding_window, max_len)
         if (kind == LOCAL_ATTN and cfg.sliding_window) else max_len)
    shape = (batch, W, cfg.num_kv_heads, cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "ks": torch.zeros(shape[:3], dtype=torch.bfloat16,
                                  device=device),
                "vs": torch.zeros(shape[:3], dtype=torch.bfloat16,
                                  device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _quantize_kv(x):
    """x: (B, 1, kv, hd) -> (int8 values, per-(B,1,kv) bf16 scale)."""
    xf = x.float()
    s = torch.clamp_min(xf.abs().amax(-1) / 127.0, 1e-8)
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127).to(torch.int8)
    return q, s.to(torch.bfloat16)


def attention_decode(p, x, cache, pos: int, cfg, kind):
    """One-token decode step.  x: (B, 1, d); pos: int, the same for the
    whole batch (under M-RoPE, for all three streams, as the reference
    rotates).  Keys are rotated at insert time so the ring buffer never
    re-rotates.  Writes the new token into ``cache`` in place (slot
    pos % W) and returns (y, cache)."""
    B = x.shape[0]
    q, k, v = _project_qkv(p, x, cfg)
    posb = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    if cfg.mrope:
        posb = posb[None].expand(3, B, 1)
    q, k = _position_rotary(q, k, posb, cfg)
    W = cache["k"].shape[1]
    slot = pos % W
    if "ks" in cache:
        for name, t in (("k", k), ("v", v)):
            tq, ts = _quantize_kv(t)
            cache[name][:, slot] = tq[:, 0]
            cache[name + "s"][:, slot] = ts[:, 0]
        # dequantize for the attention reads
        ck = (cache["k"].float() * cache["ks"].float()[..., None]).to(x.dtype)
        cv = (cache["v"].float() * cache["vs"].float()[..., None]).to(x.dtype)
    else:
        cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
        ck, cv = cache["k"], cache["v"]
    # validity: slot t holds absolute position p_t; with ring writes,
    # valid iff its position <= pos and within window (local) / history.
    idx = torch.arange(W, device=x.device)
    wraps = (pos // W) * W + idx
    abs_pos = torch.where(idx <= slot, wraps, wraps - W)
    valid = abs_pos >= 0
    if kind == LOCAL_ATTN and cfg.sliding_window:
        valid &= (pos - abs_pos) < cfg.sliding_window
    else:
        valid &= abs_pos <= pos
    mask = valid[None, None, :].expand(B, 1, W)
    out = _sdpa(q, ck, cv, mask, cfg.attn_softcap)
    return out.reshape(B, 1, -1) @ p["wo"].to(x.dtype), cache


# --------------------------------------------------------------------------
# MLP (SwiGLU / GELU)
# --------------------------------------------------------------------------
def init_mlp(generator, d, d_ff, act="silu", device=None):
    if act == "silu":  # gated
        return {"w_gate": dense_init(generator, (d, d_ff), device=device),
                "w_up": dense_init(generator, (d, d_ff), device=device),
                "w_down": dense_init(generator, (d_ff, d), device=device)}
    return {"w_up": dense_init(generator, (d, d_ff), device=device),
            "w_down": dense_init(generator, (d_ff, d), device=device)}


def apply_mlp(p, x):
    if "w_gate" in p:
        h = F.silu(x @ p["w_gate"].to(x.dtype)) * (x @ p["w_up"].to(x.dtype))
    else:  # jax.nn.gelu's default: the tanh approximation
        h = F.gelu(x @ p["w_up"].to(x.dtype), approximate="tanh")
    return h @ p["w_down"].to(x.dtype)
