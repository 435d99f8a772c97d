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

``apply_moe_shard_map`` is the expert-parallel layer of one rank of a
mesh (the reference's ``shard_map`` body, with the collectives of
``sharding.collectives``); ``apply_moe_auto`` takes it when an
activation policy with more than one model rank is installed.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import apply_mlp, dense_init, init_mlp
from repro_torch.sharding import collectives as coll
from repro_torch.sharding.ctx import current_policy


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


def dispatch(top_e, C: int, E: int, before=None, W=None):
    """The sort-based plan: (order, the stable sort of the flat (T*k,)
    assignments by expert; slot, each sorted assignment's row of the
    (E*W + 1, d) buffer, W = C unless given: its rank within its expert's
    run if that is below C, else the spare row E*W, which drops it).

    ``before`` (E,) counts each expert's assignments that precede these in
    a larger batch's stable sort: an assignment is then kept where
    ``before[e]`` + its rank is below C (a kept rank is below
    min(C, T*k), the W that holds them all)."""
    flat_e = top_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    pos = torch.arange(se.numel(), device=se.device)
    seg_start = torch.searchsorted(se, torch.arange(E, device=se.device))
    rank = pos - seg_start[se]
    W = C if W is None else W
    keep = rank < C if before is None else before[se] + rank < C
    return order, torch.where(keep, se * W + rank, E * W)


def _aux_loss(probs, top_e, moe_cfg, mean=None):
    """Switch-style load-balance loss (f32 scalar) of the tokens' expert
    fractions and mean probabilities; ``mean`` makes those of a rank's
    tokens the means over all ranks' tokens (equal shares)."""
    E = moe_cfg.num_experts
    experts = torch.arange(E, device=probs.device)
    frac_tokens = (top_e[:, :1] == experts).float().mean(0)
    frac_probs = probs.mean(0)
    if mean is not None:
        frac_tokens, frac_probs = mean(frac_tokens), mean(frac_probs)
    return E * torch.sum(frac_tokens * frac_probs) * moe_cfg.router_aux_weight


def _dispatch_buffer(xt, top_e, C: int, E: int, before=None):
    """-> (the (E, W, d) expert buffer of the (T, d) tokens, order, slot):
    assignments past an expert's C dropped; W is C, or with ``before``
    (``dispatch``) min(C, T*k)."""
    k = top_e.shape[1]
    W = C if before is None else min(C, top_e.numel())
    order, slot = dispatch(top_e, C, E, before, W)
    buf = xt.new_zeros((E * W + 1, xt.shape[1]))
    buf[slot] = xt[order // k]
    return buf[:E * W].reshape(E, W, xt.shape[1]), order, slot


def _experts(eb, w_gate, w_up, w_down):
    """The batched SwiGLU experts over an (E, C, d) buffer."""
    dt = eb.dtype
    h = F.silu(torch.bmm(eb, w_gate.to(dt)))
    h = h * torch.bmm(eb, w_up.to(dt))
    return torch.bmm(h, w_down.to(dt))


def _combine(eo, order, slot, top_w):
    """Each token's k expert outputs of the (E*C, d) ``eo`` weighted and
    added in sorted-assignment order (dropped assignments add 0) -> (T, d)."""
    T, k = top_w.shape
    d = eo.shape[-1]
    eo = torch.cat([eo.reshape(-1, d), eo.new_zeros((1, d))])
    sw = top_w.reshape(-1)[order]
    contrib = eo[slot] * sw[:, None].to(eo.dtype)     # (T*k, d), sorted
    sorted_at = torch.empty_like(order)           # flat -> sorted position
    sorted_at[order] = torch.arange(T * k, device=order.device)
    mine = contrib[sorted_at.reshape(T, k).sort(dim=1).values]  # (T, k, d)
    out = eo.new_zeros((T, d))
    for i in range(k):
        out = out + mine[:, i]
    return out


def _shared(p, xt, out):
    if "shared" in p:
        sg = torch.sigmoid(xt @ p["shared_gate"].to(xt.dtype))
        out = out + sg * apply_mlp(p["shared"], xt)
    return out


def _moe_tokens(p, xt, moe_cfg, C: int, mean=None, before=None):
    """The routed and shared experts over (T, d) tokens at C slots an
    expert -> ((T, d), aux); ``before`` as in ``dispatch``, a function of
    the tokens' expert ids."""
    probs, top_w, top_e = route(p, xt, moe_cfg)
    aux = _aux_loss(probs, top_e, moe_cfg, mean)
    eb, order, slot = _dispatch_buffer(
        xt, top_e, C, moe_cfg.num_experts,
        None if before is None else before(top_e))
    eo = _experts(eb, p["w_gate"], p["w_up"], p["w_down"])
    return _shared(p, xt, _combine(eo, order, slot, top_w)), aux


def apply_moe(p, x, moe_cfg, capacity=None):
    """x: (B, S, d) -> ((B, S, d), aux_loss f32 scalar), at ``capacity``
    slots an expert (default: what ``expert_capacity`` gives)."""
    B, S, d = x.shape
    C = expert_capacity(moe_cfg, B * S, S) if capacity is None else capacity
    out, aux = _moe_tokens(p, x.reshape(B * S, d), moe_cfg, C)
    return out.reshape(B, S, d), aux


def _local_experts(w, E: int, tp: int, mesh):
    """A rank's E/tp experts of an expert leaf: the leaf itself when it is
    already the rank's shard (E/tp rows), else its rows on this rank."""
    if w.shape[0] == E // tp:
        return w
    i = mesh.get_local_rank("model")
    return w[i * (E // tp):(i + 1) * (E // tp)]


def _whole_experts(w, E: int, mesh):
    """An expert leaf with all E experts (gathered over "model" when the
    rank holds only its shard)."""
    return w if w.shape[0] == E else coll.all_gather(w, 0, mesh, "model")


def _dp_index(mesh, dp) -> int:
    """The rank's index over the dp axes, major to minor (its batch
    shard's place in the global batch)."""
    di = 0
    for a in dp:
        di = di * mesh.size(mesh.mesh_dim_names.index(a)) + \
            mesh.get_local_rank(a)
    return di


def _fallback(p, x, moe_cfg, policy, capacity=None):
    """The reference's fallback to its SPMD ``apply_moe`` over the global
    batch, on one rank: the rank's batch through all E experts (gathered
    whole).  Where the batch is sharded over the dp axes, the capacity is
    the global batch's, and the rank keeps an assignment where its place
    in the global batch's stable sort by expert is below it: the ranks
    all-gather their (E,) counts of assignments by expert, and those of
    the ranks before this one offset its own ranks (``dispatch``'s
    ``before``).  The aux loss is from the expert fractions and
    probabilities averaged over the dp axes (equal shares), so it is the
    global batch's too."""
    mesh, E = policy["mesh"], moe_cfg.num_experts
    whole = {n: (_whole_experts(w, E, mesh)
                 if n in ("w_gate", "w_up", "w_down") else w)
             for n, w in p.items()}
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    if not (policy["batch_sharded"] and policy["dp_size"] > 1):
        C = expert_capacity(moe_cfg, B * S, S) if capacity is None \
            else capacity
        out, aux = _moe_tokens(whole, xt, moe_cfg, C)
        return out.reshape(B, S, d), aux
    dp, dps = policy["dp"], policy["dp_size"]

    def mean(t):
        return coll.all_reduce(t, mesh, dp) / dps

    def before(top_e):
        flat = top_e.reshape(-1)
        n = flat.new_zeros((1, E)).index_add_(
            1, flat, torch.ones_like(flat)[None])
        for a in reversed(dp):            # (dps, E), in dp-index order
            n = coll.all_gather(n, 0, mesh, a)
        return n[:_dp_index(mesh, dp)].sum(0)

    C = expert_capacity(moe_cfg, B * S * dps, S) if capacity is None \
        else capacity
    out, aux = _moe_tokens(whole, xt, moe_cfg, C, mean, before)
    return out.reshape(B, S, d), aux


def apply_moe_shard_map(p, x, moe_cfg, policy, capacity=None):
    """The expert-parallel MoE of one rank: the reference's ``shard_map``
    over the policy's mesh, run by every rank on its own tokens.

    ``x`` is the rank's batch: its shard over the dp axes when
    ``policy["batch_sharded"]`` (the input specs), else the whole batch.
    The tokens are split over (data x model) when the global T divides,
    else over data, so that model ranks route different tokens.  Each
    rank routes its T_loc tokens, averages the aux loss over the token
    axes, dispatches them into an (E, C_loc, d) buffer and sends each
    model rank its E/tp experts' rows (an all-to-all over "model": split
    on E, concatenated on C); the rank runs its local experts on the
    (E/tp, tp*C_loc, d) it receives, and the results go back the same
    way.  The outputs are gathered back to the rank's batch.  The expert
    leaves may be the rank's own (E/tp, ...) shards (``P("model", ...)``,
    as the train step holds them) or whole; the shared expert runs
    densely.  Where E does not divide over "model" or T over the dp axes,
    it falls back as the reference does (``_fallback``)."""
    m = moe_cfg
    mesh = policy["mesh"]
    dp = policy["dp"]
    dps, tps = policy["dp_size"], policy["tp_size"]
    B, S, d = x.shape
    E = m.num_experts
    T_rank = B * S
    T = T_rank * dps if policy["batch_sharded"] else T_rank
    if E % tps != 0 or T % dps != 0:
        return _fallback(p, x, m, policy, capacity)
    E_loc = E // tps
    two_d = T % (dps * tps) == 0
    T_loc = T // (dps * tps) if two_d else T // dps
    if capacity is None:
        C_loc = T_loc if S == 1 else max(
            1, int(m.capacity_factor * T_loc * m.top_k / E))
    else:
        C_loc = capacity

    xt = x.reshape(T_rank, d)
    # the rank's own tokens: its data shard (if it holds the whole batch),
    # then its model rank's part of that
    tok = xt
    if not policy["batch_sharded"]:
        di = _dp_index(mesh, dp)
        tok = tok[di * (T // dps):(di + 1) * (T // dps)]
    if two_d:
        mi = mesh.get_local_rank("model")
        tok = tok[mi * T_loc:(mi + 1) * T_loc]

    probs, top_w, top_e = route(p, tok, m)
    tok_axes = dp + ("model",) if two_d else dp
    n_tok = dps * tps if two_d else dps
    aux = coll.all_reduce(_aux_loss(probs, top_e, m), mesh, tok_axes) / n_tok

    buf, order, slot = _dispatch_buffer(tok, top_e, C_loc, E)
    # ---- expert-parallel exchange: (E, C_loc, d) split on E ----
    recv = coll.all_to_all(buf, mesh, "model")          # (tp*E_loc, C_loc, d)
    recv = recv.reshape(tps, E_loc, C_loc, d).transpose(0, 1).reshape(
        E_loc, tps * C_loc, d)
    eo = _experts(recv, *(_local_experts(p[n], E, tps, mesh)
                          for n in ("w_gate", "w_up", "w_down")))
    eo = eo.reshape(E_loc, tps, C_loc, d).transpose(0, 1).reshape(
        tps * E_loc, C_loc, d)
    send = coll.all_to_all(eo, mesh, "model")            # (E, C_loc, d)
    out = _combine(send, order, slot, top_w)             # (T_loc, d)

    # ---- back to the rank's batch ----
    if two_d:
        out = coll.all_gather(out, 0, mesh, "model")
    if not policy["batch_sharded"]:
        for a in reversed(dp):
            out = coll.all_gather(out, 0, mesh, a)
    return _shared(p, xt, out).reshape(B, S, d), aux


def apply_moe_auto(p, x, moe_cfg, capacity=None):
    """``apply_moe_shard_map`` when an activation policy with more than one
    model rank is installed, else ``apply_moe``."""
    pol = current_policy()
    if pol is not None and pol["tp_size"] > 1:
        return apply_moe_shard_map(p, x, moe_cfg, pol, capacity)
    return apply_moe(p, x, moe_cfg, capacity)
