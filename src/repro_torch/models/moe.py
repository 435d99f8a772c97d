"""Mixture-of-Experts FFN with sort-based capacity dispatch (the port of
``repro.models.moe``: ``init_moe`` and ``apply_moe``).

Tokens are flattened, their top-k assignments sorted by expert id (stable),
scattered into an (E, C, d) buffer, run through the SwiGLU experts as
batched products, and gathered back with the router weights.  Assignments
past an expert's capacity C are dropped (capacity-factor semantics); a
Switch-style aux loss balances the load.  Qwen-style shared experts run
densely beside the routed ones behind a sigmoid gate.

Differences from the reference, none of them in the values:

* top-k is a stable descending sort, so ties go to the lower expert id
  (``jax.lax.top_k``'s order; ``torch.topk`` promises none);
* the scatter's ``mode="drop"`` becomes a spare buffer row that takes
  every dropped assignment and is cut off;
* the combine adds each token's k contributions in one fixed order, the
  sorted-assignment order in which the reference's scatter-add applies
  them, rather than by ``index_add_`` (atomic on the card, so its bf16
  rounding would change from call to call): two calls are equal;
* nothing reads a value on the host (C comes from shapes), so the layer
  runs on the card without a sync.

The expert-parallel ``apply_moe_shard_map`` comes with the mesh slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import apply_mlp, dense_init, init_mlp


def init_moe(generator, d_model, moe_cfg, device=None):
    m = moe_cfg
    E, f = m.num_experts, m.d_expert
    p = {"router": dense_init(generator, (d_model, E), device=device),
         # experts stacked on axis 0
         "w_gate": dense_init(generator, (E, d_model, f), 1, device),
         "w_up": dense_init(generator, (E, d_model, f), 1, device),
         "w_down": dense_init(generator, (E, f, d_model), 1, device)}
    if m.num_shared_experts:
        p["shared"] = init_mlp(generator, d_model, m.d_shared, "silu", device)
        p["shared_gate"] = dense_init(generator, (d_model, 1), device=device)
    return p


def expert_capacity(moe_cfg, T: int, S: int) -> int:
    """Slots an expert takes: all T tokens at decode (S == 1: lossless),
    else ``int(capacity_factor * T * k / E)``, at least 1."""
    m = moe_cfg
    if S == 1:
        return T
    return int(m.capacity_factor * T * m.top_k / m.num_experts) or 1


def route(p, xt, moe_cfg):
    """Router of the (T, d) tokens -> (probs (T, E) f32, renormalised
    top-k weights (T, k), their expert ids (T, k), descending, ties to the
    lower id)."""
    logits = (xt @ p["router"].to(xt.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :moe_cfg.top_k], top_e[:, :moe_cfg.top_k]
    return probs, top_w / top_w.sum(-1, keepdim=True), top_e


def dispatch(top_e, C: int, E: int):
    """The sort-based plan: (order, the stable sort of the flat (T*k,)
    assignments by expert; slot, each sorted assignment's row of the
    (E*C + 1, d) buffer: its rank within its expert's run if that is below
    C, else the spare row E*C, which drops it)."""
    flat_e = top_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    pos = torch.arange(se.numel(), device=se.device)
    seg_start = torch.searchsorted(se, torch.arange(E, device=se.device))
    rank = pos - seg_start[se]
    slot = torch.where(rank < C, se * C + rank, E * C)
    return order, slot


def apply_moe(p, x, moe_cfg):
    """x: (B, S, d) -> ((B, S, d), aux_loss f32 scalar), at the capacity
    ``expert_capacity`` gives."""
    m = moe_cfg
    B, S, d = x.shape
    T, k, E = B * S, m.top_k, m.num_experts
    xt = x.reshape(T, d)
    probs, top_w, top_e = route(p, xt, m)

    # ---- aux load-balance loss (Switch-style) ----
    experts = torch.arange(E, device=x.device)
    frac_tokens = (top_e[:, :1] == experts).float().mean(0)
    aux = E * torch.sum(frac_tokens * probs.mean(0)) * m.router_aux_weight

    # ---- sort-based dispatch ----
    C = expert_capacity(m, T, S)
    order, slot = dispatch(top_e, C, E)
    st = order // k                                  # token of each
    sw = top_w.reshape(-1)[order]
    buf = x.new_zeros((E * C + 1, d))
    buf[slot] = xt[st]
    eb = buf[:E * C].reshape(E, C, d)

    # ---- experts: batched SwiGLU ----
    h = F.silu(torch.bmm(eb, p["w_gate"].to(x.dtype)))
    h = h * torch.bmm(eb, p["w_up"].to(x.dtype))
    eo = torch.bmm(h, p["w_down"].to(x.dtype)).reshape(E * C, d)

    # ---- combine, in sorted-assignment order per token ----
    eo = torch.cat([eo, eo.new_zeros((1, d))])       # dropped: 0
    contrib = eo[slot] * sw[:, None].to(x.dtype)      # (T*k, d), sorted
    sorted_at = torch.empty_like(order)          # flat -> sorted position
    sorted_at[order] = torch.arange(T * k, device=x.device)
    mine = contrib[sorted_at.reshape(T, k).sort(dim=1).values]  # (T, k, d)
    out = x.new_zeros((T, d))
    for i in range(k):
        out = out + mine[:, i]

    if "shared" in p:
        sg = torch.sigmoid(xt @ p["shared_gate"].to(x.dtype))
        out = out + sg * apply_mlp(p["shared"], xt)
    return out.reshape(B, S, d), aux
