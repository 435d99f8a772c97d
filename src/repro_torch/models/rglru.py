"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

y = W_out( GeLU(W_gate x) * RG_LRU(conv1d(W_x x)) )

RG-LRU recurrence (per channel):
    r_t = sigmoid(W_a x_t + b_a)          # recurrence gate
    i_t = sigmoid(W_i x_t + b_i)          # input gate
    a_t = exp(-c * softplus(Lambda) * r_t)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The port of ``repro.models.rglru``.  The train / prefill path runs the
recurrence through ``kernels.ops.rglru_scan`` (the CUDA kernel for CUDA
tensors, its plain version for CPU ones), forward and backward: its
gradient is the backward kernel's on the card and the plain backward's on
the CPU.  So there is no ``use_kernel`` switch; the reference computes the
same recurrence with ``jax.lax.associative_scan`` unless asked for its
forward-only Pallas kernel, and trains through the former.  Decode is a
single fused step.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init

C_SCALE = 8.0


def init_rglru_block(generator, d_model, width, conv_width=4, device=None):
    w = width or d_model

    def zeros():
        return torch.zeros((w,), dtype=torch.float32, device=device)

    p = {"w_x": dense_init(generator, (d_model, w), device=device),
         "w_gate": dense_init(generator, (d_model, w), device=device),
         "conv_w": dense_init(generator, (conv_width, w), device=device),
         "conv_b": zeros(),
         "w_a": dense_init(generator, (w, w), device=device),
         "b_a": zeros(),
         "w_i": dense_init(generator, (w, w), device=device),
         "b_i": zeros()}
    # Lambda parametrized so a is in (0.9, 0.999) at init
    u = torch.rand((w,), generator=generator, device=device,
                   dtype=torch.float32) * (0.999 - 0.9) + 0.9
    p["log_lambda"] = torch.log(torch.expm1(-torch.log(u) * C_SCALE))
    p["w_out"] = dense_init(generator, (w, d_model), device=device)
    return p


def _gelu(x):
    return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default


def _gates(p, u):
    """u: (..., w) conv output -> (a, b) of the affine recurrence h = a h + b,
    both f32."""
    r = torch.sigmoid(u @ p["w_a"].to(u.dtype) + p["b_a"].to(u.dtype))
    i = torch.sigmoid(u @ p["w_i"].to(u.dtype) + p["b_i"].to(u.dtype))
    lam = p["log_lambda"]
    softplus = torch.logaddexp(lam, torch.zeros_like(lam))  # jax.nn.softplus
    log_a = -softplus.float() * r.float()
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-9)) * \
        (i.float() * u.float())
    return a, b


def causal_conv1d(p, x):
    """Depthwise causal conv. x: (B, S, w)."""
    K = p["conv_w"].shape[0]
    S = x.shape[1]
    pads = F.pad(x, (0, 0, K - 1, 0))
    out = sum(pads[:, k:k + S, :] * p["conv_w"][k].to(x.dtype)
              for k in range(K))
    return out + p["conv_b"].to(x.dtype)


def rglru_block_forward(p, x):
    """x: (B, S, d) -> (B, S, d).  Train/prefill path."""
    gate = _gelu(x @ p["w_gate"].to(x.dtype))
    u = causal_conv1d(p, x @ p["w_x"].to(x.dtype))
    a, b = _gates(p, u)
    h = ops.rglru_scan(a, b)
    return (h.to(x.dtype) * gate) @ p["w_out"].to(x.dtype)


def init_rglru_state(cfg, batch, dtype, device=None):
    w = cfg.rglru_width or cfg.d_model
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv1d_width - 1, w), dtype=dtype,
                                device=device)}


def rglru_block_decode(p, x, state):
    """One-step decode. x: (B, 1, d) -> (y, new state)."""
    gate = _gelu(x @ p["w_gate"].to(x.dtype))
    xin = (x @ p["w_x"].to(x.dtype))[:, 0]                          # (B, w)
    hist_dtype = torch.promote_types(state["conv"].dtype, xin.dtype)
    hist = torch.cat([state["conv"].to(hist_dtype),
                      xin[:, None].to(hist_dtype)], dim=1)           # (B, K, w)
    u = torch.einsum("bkw,kw->bw", hist.float(),
                     p["conv_w"].float()) + p["conv_b"]
    a, b = _gates(p, u)
    h = a * state["h"] + b
    y = (h[:, None].to(x.dtype) * gate) @ p["w_out"].to(x.dtype)
    return y, {"h": h, "conv": hist[:, 1:].to(state["conv"].dtype)}
