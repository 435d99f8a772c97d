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
from repro_torch.sharding import collectives as coll
from repro_torch.sharding.specs import P


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


def _scores(q, k, mask, softcap):
    """q: (B,S,Hq,hd) k: (B,T,Hkv,hd); GQA via head grouping; mask
    (B,S,T) -> f32 logits (B,Hkv,g,S,T), softcapped, -1e30 where masked."""
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    qf = q.float().reshape(B, S, Hkv, Hq // Hkv, hd)
    logits = torch.einsum("bskgd,btkd->bkgst", qf, k.float()) / math.sqrt(hd)
    logits = _softcap(logits, softcap)
    return torch.where(mask[:, None, None], logits, -1e30)


def _sdpa(q, k, v, mask, softcap=0.0):
    """Plain f32 attention (the decode step's), in q's dtype."""
    probs = torch.softmax(_scores(q, k, mask, softcap), dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(q.shape).to(q.dtype)


def partial_attention(q, k, v, mask, softcap=0.0):
    """``_sdpa`` over one piece of a cache, in f32, with each row's
    log-sum-exp over its valid keys -> (out (B,S,Hq,hd), lse (B,S,Hq); -inf
    where a row has no valid key): what
    ``sharding.collectives.merge_attention`` combines across pieces."""
    logits = _scores(q, k, mask, softcap)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    lse = torch.where(mask.any(-1)[:, None, None],
                      torch.logsumexp(logits, dim=-1), -math.inf)
    return out.reshape(q.shape), lse.permute(0, 3, 1, 2).reshape(q.shape[:3])


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


def _write_slot(t, new, slot: int, piece, name: str):
    """Cache leaf ``t`` (B, W, heads, ...) takes the new token's ``new``
    (B, all kv heads, ...) at global slot ``slot``: the whole leaf, or the
    rank's ``piece`` of it (its heads, and only if it holds the slot)."""
    lo, hi = (0, t.shape[1]) if piece is None else \
        piece.range(name, 1, t.shape[1])
    h0, h1 = (0, t.shape[2]) if piece is None else \
        piece.range(name, 2, t.shape[2])
    if lo <= slot < hi:
        t[:, slot - lo] = new[:, h0:h1].to(t.dtype)


def attention_decode(p, x, cache, pos: int, cfg, kind, piece=None):
    """One-token decode step.  x: (B, 1, d); pos: int, the same for the
    whole batch (under M-RoPE, for all three streams, as the reference
    rotates).  Keys are rotated at insert time so the ring buffer never
    re-rotates.  Writes the new token into ``cache`` in place (slot
    pos % W) and returns (y, cache).

    With a ``piece`` (``sharding.collectives.StatePiece``: a sharded serve
    step) ``cache`` holds the rank's piece of each leaf: slots [lo, lo +
    W_loc) of the ring's W and a range of its kv heads.  The slot and the
    validity rule go by global index; only the rank holding slot pos % W
    writes it; the rank attends its kv heads' query heads over its slots
    (``partial_attention``), the pieces are merged over the axes that
    split the slots and the heads' outputs gathered over those that split
    the heads, before ``wo``."""
    B = x.shape[0]
    q, k, v = _project_qkv(p, x, cfg)
    posb = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    if cfg.mrope:
        posb = posb[None].expand(3, B, 1)
    q, k = _position_rotary(q, k, posb, cfg)
    Wl = cache["k"].shape[1]
    lo, W = 0, Wl
    if piece is not None:
        lo, _ = piece.range("k", 1, Wl)
        W = piece.extent("k", 1, Wl)
        h0, h1 = piece.range("k", 2, cache["k"].shape[2])
        g = cfg.num_heads // cfg.num_kv_heads
        q = q[:, :, h0 * g:h1 * g]
    slot = pos % W
    if "ks" in cache:
        for name, t in (("k", k), ("v", v)):
            tq, ts = _quantize_kv(t)
            _write_slot(cache[name], tq[:, 0], slot, piece, name)
            _write_slot(cache[name + "s"], ts[:, 0], slot, piece, name + "s")
        # dequantize for the attention reads; a rank's scales are whole
        # over the slots and heads (``decode_state_specs`` splits them
        # over the batch only): the piece's are cut out
        ks, vs = cache["ks"], cache["vs"]
        if piece is not None:
            ks, vs = ks[:, lo:lo + Wl, h0:h1], vs[:, lo:lo + Wl, h0:h1]
        ck = (cache["k"].float() * ks.float()[..., None]).to(x.dtype)
        cv = (cache["v"].float() * vs.float()[..., None]).to(x.dtype)
    else:
        _write_slot(cache["k"], k[:, 0], slot, piece, "k")
        _write_slot(cache["v"], v[:, 0], slot, piece, "v")
        ck, cv = cache["k"], cache["v"]
    # validity: slot t holds absolute position p_t; with ring writes,
    # valid iff its position <= pos and within window (local) / history.
    idx = torch.arange(lo, lo + Wl, device=x.device)
    wraps = (pos // W) * W + idx
    abs_pos = torch.where(idx <= slot, wraps, wraps - W)
    valid = abs_pos >= 0
    if kind == LOCAL_ATTN and cfg.sliding_window:
        valid &= (pos - abs_pos) < cfg.sliding_window
    else:
        valid &= abs_pos <= pos
    mask = valid[None, None, :].expand(B, 1, Wl)
    if piece is not None and piece.seq_axes:
        o, lse = partial_attention(q, ck, cv, mask, cfg.attn_softcap)
        out = coll.merge_attention(o, lse, piece.mesh,
                                   piece.seq_axes).to(q.dtype)
    else:
        out = _sdpa(q, ck, cv, mask, cfg.attn_softcap)
    if piece is not None and piece.head_axes:
        out = coll.gather(out, P(None, None, piece.head_axes), piece.mesh)
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
