"""Decoder or encoder LM assembled from the block zoo (the port of
``repro.models.transformer``: prefill, decode and the training loss).

Depth handling keeps the reference's parameter layout: the config's
``block_pattern`` (period P) tiles the depth; ``params["stages"]`` holds
one dict per pattern position whose leaves are stacked over the R = L // P
repetitions, and ``params["rest"]`` the remaining L mod P layers.  Where
the reference runs ``jax.lax.scan`` over the stacked leaves, the port
loops over R in Python and indexes them as views.  Decode states are
stacked the same way; ``decode_step`` updates them in place.

Entry points:
  * ``forward(params, batch, cfg)``            -> (logits, aux) for prefill
  * ``lm_loss(params, batch, cfg, remat)``     -> (loss + aux, (loss, aux))
  * ``init_decode_state(cfg, batch, max_len)`` -> stacked caches
  * ``decode_step(params, state, tokens, pos, cfg)`` -> (logits, state)

``lm_loss`` is differentiable through every layer (the attention and
scan kernels have backward kernels on the card).  Its cross-entropy runs
in sequence chunks that are recomputed in the backward, and ``remat``
recomputes each pattern repetition, grouped two-level for deep stacks,
with ``torch.utils.checkpoint`` where the reference uses
``jax.checkpoint``; the MoE layers' aux loss is carried through each
recomputed span beside the residual stream, summed in the reference's
order.

Layer kinds: global and local attention, RG-LRU, MoE (attention, then
``models.moe.apply_moe_auto`` on the rmsnorm'd residual), and xLSTM's mLSTM
and sLSTM (``models.xlstm``; with d_ff 0 such a layer is ``x +
block(norm1(x))``).  Front ends (stubs, as in the
reference): an audio model (HuBERT) takes frame embeddings (B, S, d) and
has no token embedding; a vision model (Qwen2-VL) takes tokens with patch
embeddings scattered into them and M-RoPE's (3, B, S) positions.  An
encoder's loss is masked prediction over ``targets`` where
``target_mask`` is set.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import (ATTN, LOCAL_ATTN, MLSTM, MOE, RECURRENT,
                                      SLSTM, ModelConfig)
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.sharding import collectives as coll
from repro_torch.sharding.ctx import current_shards
# one conversion carries any of the reference's parameter trees across
from repro_torch.tree import params_from_jax  # noqa: F401  (re-export)
from repro_torch.tree import leaves, tree_map

KINDS = (ATTN, LOCAL_ATTN, RECURRENT, MOE, MLSTM, SLSTM)
ATTENTION_KINDS = (ATTN, LOCAL_ATTN, MOE)


def _check_kind(kind: str):
    if kind not in KINDS:
        raise ValueError(kind)


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _norm_kind(cfg: ModelConfig) -> str:
    return "rmsnorm" if cfg.causal else "layernorm"


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------
def init_layer(generator, cfg: ModelConfig, kind: str, device=None):
    _check_kind(kind)
    p: Dict[str, Any] = {"norm1": L.init_norm(cfg.d_model, _norm_kind(cfg),
                                              device)}
    if kind == RECURRENT:
        p["rglru"] = rglru_lib.init_rglru_block(
            generator, cfg.d_model, cfg.rglru_width, cfg.conv1d_width, device)
    elif kind == MLSTM:
        p["mlstm"] = xlstm_lib.init_mlstm(generator, cfg.d_model,
                                          cfg.num_heads, device)
    elif kind == SLSTM:
        p["slstm"] = xlstm_lib.init_slstm(generator, cfg.d_model,
                                          cfg.num_heads, device)
    else:
        p["attn"] = L.init_attention(generator, cfg, device)
    if kind == MOE:     # its norm is rmsnorm whatever the model's
        p["norm2"] = L.init_norm(cfg.d_model, "rmsnorm", device)
        p["moe"] = moe_lib.init_moe(generator, cfg.d_model, cfg.moe, device)
    elif cfg.d_ff:
        p["norm2"] = L.init_norm(cfg.d_model, _norm_kind(cfg), device)
        p["mlp"] = L.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.act,
                              device)
    return p


def _stacked(generator, cfg: ModelConfig, kind: str, R: int, device):
    """R layers of ``kind`` drawn in turn into one stacked tree (leaves
    (R, ...)): only one layer's draw lives beside the stack, so a stage
    at full width never needs twice its size."""
    out = None
    for r in range(R):
        layer = init_layer(generator, cfg, kind, device)
        if out is None:
            out = tree_map(lambda t: t.new_empty((R,) + t.shape), layer)
        for dst, src in zip(leaves(out), leaves(layer)):
            dst[r].copy_(src)
    return out


def init_model(cfg: ModelConfig, generator=None, device=None) -> Dict[str, Any]:
    """Random parameters from the reference's distributions, f32 (an audio
    model, which takes frame embeddings, has no ``embed``).  The numbers
    differ from jax's; carry the reference's own across with
    ``params_from_jax`` where they must match."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    kinds = cfg.layer_kinds
    P = len(cfg.block_pattern)
    R = cfg.num_layers // P
    params: Dict[str, Any] = {}
    if cfg.modality_frontend != "audio":
        params["embed"] = L.dense_init(generator,
                                       (cfg.vocab_size, cfg.d_model),
                                       device=device)
    params["stages"] = tuple(_stacked(generator, cfg, kind, R, device)
                             for kind in cfg.block_pattern)
    params["rest"] = tuple(init_layer(generator, cfg, kinds[R * P + i], device)
                           for i in range(cfg.num_layers - R * P))
    params["final_norm"] = L.init_norm(cfg.d_model, _norm_kind(cfg), device)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(generator,
                                         (cfg.d_model, cfg.vocab_size),
                                         device=device)
    return params


def param_count(params) -> int:
    """Number of parameters in a tree (summed ``numel``)."""
    return sum(t.numel() for t in leaves(params))


def _layer(stage, r: int):
    """Repetition ``r`` of a stacked stage, as views (a sharded train
    step's ``sharding.collectives.ShardedStack`` leaves gather it here,
    inside the layer's remat region)."""
    return tree_map(lambda t: t[r], stage)


def _layers(params, cfg: ModelConfig, stages: bool = True):
    """(params, kind) of every layer in depth order (only the unstacked
    tail's when ``stages`` is False)."""
    P = len(cfg.block_pattern)
    R = cfg.num_layers // P
    for r in range(R if stages else 0):
        for j, kind in enumerate(cfg.block_pattern):
            yield _layer(params["stages"][j], r), kind
    for i, p in enumerate(params["rest"]):
        yield p, cfg.layer_kinds[R * P + i]


# --------------------------------------------------------------------------
# layer application (full-sequence)
# --------------------------------------------------------------------------
def _ffn(p, x, cfg: ModelConfig, kind: str, aux):
    """The layer's second residual half: ``apply_moe_auto`` (its aux loss
    added to ``aux``) or the MLP, on the norm'd residual."""
    if kind == MOE:
        h, a = moe_lib.apply_moe_auto(p["moe"], L.apply_norm(p["norm2"], x,
                                                             cfg.norm_eps),
                                      cfg.moe)
        return x + h, aux + a
    if cfg.d_ff:
        x = x + L.apply_mlp(p["mlp"], L.apply_norm(p["norm2"], x, cfg.norm_eps))
    return x, aux


def apply_layer(p, x, aux, cfg: ModelConfig, kind: str, positions):
    """One pre-norm residual layer over the full sequence -> (x, aux + the
    layer's MoE aux loss)."""
    _check_kind(kind)
    h = L.apply_norm(p["norm1"], x, cfg.norm_eps)
    if kind == RECURRENT:
        h = rglru_lib.rglru_block_forward(p["rglru"], h)
    elif kind == MLSTM:
        h = xlstm_lib.mlstm_forward(p["mlstm"], h, cfg.num_heads)
    elif kind == SLSTM:
        h = xlstm_lib.slstm_forward(p["slstm"], h, cfg.num_heads)
    else:
        h = L.attention_forward(p["attn"], h, cfg, kind, positions)
    return _ffn(p, x + h, cfg, kind, aux)


def _embed(params, tokens, cfg: ModelConfig):
    """Gather, then cast: the same values as the reference's cast-then-
    gather without casting the whole table.  In a sharded prefill or serve
    step ``embed`` is the rank's vocabulary slice: each rank looks up the
    tokens it holds (zeros elsewhere), summed over the axes that split the
    vocabulary (one term is not zero: the sum is exact)."""
    table = params["embed"]
    shards = current_shards()
    vocab = None if shards is None else shards.vocab_piece(table.shape[0])
    if vocab is None:
        x = table[tokens.long()].to(_dtype(cfg))
    else:
        lo, axes, mesh = vocab
        ids = tokens.long() - lo
        mine = (ids >= 0) & (ids < table.shape[0])
        x = table[ids.clamp(0, table.shape[0] - 1)].to(_dtype(cfg))
        x = coll.all_reduce(torch.where(mine[..., None], x, 0), mesh, axes)
    if cfg.tie_embeddings:
        x = x * (cfg.d_model ** 0.5)  # gemma-style lookup scaling
    return x


def embed_inputs(params, batch, cfg: ModelConfig):
    """-> (x (B, S, d) in the config's dtype, positions).  batch keys:
    ``tokens`` (B, S), or ``embeds`` (B, S, d) for an audio model; a
    vision model's ``patch_embeds`` (B, P, d) replace the token embeddings
    at ``patch_positions`` (B, P); ``positions`` (B, S), or (3, B, S)
    under M-RoPE, default ``arange(S)`` (on all three streams)."""
    if cfg.modality_frontend == "audio":
        x = batch["embeds"].to(_dtype(cfg))
    else:
        x = _embed(params, batch["tokens"], cfg)
        if cfg.modality_frontend == "vision" and "patch_embeds" in batch:
            rows = torch.arange(x.shape[0], device=x.device)[:, None]
            x = x.index_put((rows, batch["patch_positions"].long()),
                            batch["patch_embeds"].to(x.dtype))
    positions = batch.get("positions")
    if positions is None:
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device)[None, :]
        if cfg.mrope:
            positions = positions[None].expand(3, B, S)
    return x, positions


def unembed(params, x, cfg: ModelConfig, normed: bool = False):
    """The logits of the final norm'd ``x``; in a sharded prefill or serve
    step ``embed`` (``lm_head``) is the rank's vocabulary slice, so these
    are the rank's slice of the logits, never the whole."""
    h = x if normed else L.apply_norm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = h @ params["embed"].to(h.dtype).T
    else:
        logits = h @ params["lm_head"].to(h.dtype)
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def _remat_groups(R: int) -> int:
    """Pick G for two-level (sqrt-style) remat: carries saved = G + R/G
    instead of R.  Returns 1 (single level) when R is small or prime."""
    if R < 20:
        return 1
    best, best_cost = 1, R + 1
    for g in range(2, R):
        if R % g == 0 and g + R // g < best_cost:
            best, best_cost = g, g + R // g
    return best


def _remat_stages(params, x, aux, cfg: ModelConfig, positions):
    """The R pattern repetitions, each recomputed in the backward (only
    its inputs, the residual and the running aux loss, are kept); when
    ``_remat_groups(R) > 1`` they also run in G recomputed groups, so that
    only the groups' inputs persist (the reference's two-level scan).
    Returns (x, aux)."""
    R = cfg.num_layers // len(cfg.block_pattern)

    def rep(x, aux, r):
        for j, kind in enumerate(cfg.block_pattern):
            x, aux = apply_layer(_layer(params["stages"][j], r), x, aux, cfg,
                                 kind, positions)
        return x, aux

    def reps(x, aux, lo, hi):
        for r in range(lo, hi):
            x, aux = checkpoint(rep, x, aux, r, use_reentrant=False)
        return x, aux

    G = _remat_groups(R)
    if G == 1:
        return reps(x, aux, 0, R)
    K = R // G
    for grp in range(G):
        x, aux = checkpoint(reps, x, aux, grp * K, (grp + 1) * K,
                            use_reentrant=False)
    return x, aux


def forward_hidden(params, batch, cfg: ModelConfig, remat: bool = False):
    """Full-sequence forward up to the final norm'd hidden states -> (h,
    aux_loss): the MoE layers' router losses summed in depth order (0
    without MoE layers)."""
    x, positions = embed_inputs(params, batch, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if remat:
        x, aux = _remat_stages(params, x, aux, cfg, positions)
    for p, kind in _layers(params, cfg, stages=not remat):
        x, aux = apply_layer(p, x, aux, cfg, kind, positions)
    return L.apply_norm(params["final_norm"], x, cfg.norm_eps), aux


def forward(params, batch, cfg: ModelConfig):
    """Full-sequence forward -> (logits (B, S, V), aux_loss)."""
    h, aux = forward_hidden(params, batch, cfg)
    return unembed(params, h, cfg, normed=True), aux


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------
def _ce_chunk(h_chunk, targets, mask, params, cfg: ModelConfig):
    """Cross-entropy sum and token count of one sequence chunk; its logits
    never leave the chunk."""
    logits = unembed(params, h_chunk, cfg, normed=True)   # h already norm'd
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    correct = lf.gather(-1, targets.long()[..., None])[..., 0]
    nll = (lse - correct) * mask
    return nll.sum(), mask.sum()


def chunked_ce(params, h, targets, mask, cfg: ModelConfig, chunk=1024):
    """Sequence-chunked, rematerialized CE: the peak temporary is one
    chunk's logits instead of the full (B, S, V); each chunk's forward is
    recomputed in the backward."""
    B, S, d = h.shape
    c = min(chunk, S)
    nc = S // c
    rem = S - nc * c

    def f(hc, tc, mc):
        return checkpoint(_ce_chunk, hc, tc, mc, params, cfg,
                          use_reentrant=False)

    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(nc):
        sl = slice(i * c, (i + 1) * c)
        s, n = f(h[:, sl], targets[:, sl], mask[:, sl])
        tot, cnt = tot + s, cnt + n
    if rem:
        s, n = f(h[:, nc * c:], targets[:, nc * c:], mask[:, nc * c:])
        tot, cnt = tot + s, cnt + n
    return tot / torch.clamp_min(cnt, 1.0)


def lm_loss(params, batch, cfg: ModelConfig, remat: bool = False):
    """Next-token (causal) or masked-prediction (encoder: ``targets``
    where ``target_mask``, unshifted) cross-entropy, sequence-chunked so
    the full (B, S, V) logits never exist -> (loss + aux, (loss, aux))."""
    h, aux = forward_hidden(params, batch, cfg, remat)
    if cfg.causal:
        h, targets, mask = h[:, :-1], batch["tokens"][:, 1:], None
    else:
        targets, mask = batch["targets"], batch.get("target_mask")
    mask = (torch.ones(targets.shape, dtype=torch.float32, device=h.device)
            if mask is None else mask.to(torch.float32))
    loss = chunked_ce(params, h, targets, mask, cfg)
    return loss + aux, (loss, aux)


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------
def _init_layer_state(cfg, kind, batch, max_len, dtype, device):
    _check_kind(kind)
    if kind == RECURRENT:
        return rglru_lib.init_rglru_state(cfg, batch, dtype, device)
    if kind == MLSTM:       # f32 whatever the model's dtype
        return xlstm_lib.init_mlstm_state(cfg.d_model, cfg.num_heads, batch,
                                          device)
    if kind == SLSTM:
        return xlstm_lib.init_slstm_state(cfg.d_model, cfg.num_heads, batch,
                                          device)
    # an MoE layer attends globally: a full-length cache
    return L.init_kv_cache(cfg, kind, batch, max_len, dtype, device)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=None, device=None) -> Dict[str, Any]:
    device = resolve_device(device)
    dtype = dtype or _dtype(cfg)
    P = len(cfg.block_pattern)
    R = cfg.num_layers // P
    # each repetition starts from the layer's own initial state (the
    # mLSTM's m is -1e30, the sLSTM's n is 1), not from zeros
    stages = tuple(
        tree_map(lambda a: a.expand((R,) + a.shape).clone(),
                 _init_layer_state(cfg, kind, batch, max_len, dtype, device))
        for kind in cfg.block_pattern)
    kinds = cfg.layer_kinds
    rest = tuple(_init_layer_state(cfg, kinds[R * P + i], batch, max_len,
                                   dtype, device)
                 for i in range(cfg.num_layers - R * P))
    return {"stages": stages, "rest": rest}


def apply_layer_decode(p, x, state, pos: int, cfg: ModelConfig, kind: str,
                       piece=None):
    """One layer, one token -> (x, new state).  A KV cache is written in
    place; the recurrent state comes back as new tensors.  ``piece``: the
    rank's ``StatePiece`` of the layer's state in a sharded serve step
    (its KV cache is the rank's piece; a recurrent state comes gathered)."""
    _check_kind(kind)
    h = L.apply_norm(p["norm1"], x, cfg.norm_eps)
    if kind == RECURRENT:
        h, state = rglru_lib.rglru_block_decode(p["rglru"], h, state)
    elif kind == MLSTM:
        h, state = xlstm_lib.mlstm_decode(p["mlstm"], h, state, cfg.num_heads)
    elif kind == SLSTM:
        h, state = xlstm_lib.slstm_decode(p["slstm"], h, state, cfg.num_heads)
    else:
        h, state = L.attention_decode(p["attn"], h, state, pos, cfg, kind,
                                      piece)
    x, _ = _ffn(p, x + h, cfg, kind, 0.0)
    return x, state


def _layer_states(state, cfg: ModelConfig):
    """(path, state) of every layer, in depth order: the path of its leaves
    in the state tree (``("stages", j)``, whose leaves are stacked, or
    ``("rest", i)``) and its state as views of the stacked one."""
    P = len(cfg.block_pattern)
    R = cfg.num_layers // P
    for r in range(R):
        for j in range(P):
            yield ("stages", j), _layer(state["stages"][j], r)
    for i, st in enumerate(state["rest"]):
        yield ("rest", i), st


def decode_step(params, state, tokens, pos: int, cfg: ModelConfig):
    """One decode step.  tokens: (B,) integer tensor; pos: int.  Returns
    (logits (B, V), state), the state updated in place.

    In a sharded serve step (``launch.steps.shard_serve_step``) ``state``
    holds the rank's shards: each layer attends over its piece of the KV
    cache, and a recurrent state is gathered for its layer, and only the
    rank's slice of the new one is written back."""
    shards = current_shards()
    x = _embed(params, tokens, cfg)[:, None]                    # (B, 1, d)
    for (p, kind), (path, st) in zip(_layers(params, cfg),
                                     _layer_states(state, cfg)):
        piece = None if shards is None else shards.state_piece(path)
        x, new = apply_layer_decode(p, x, st if piece is None
                                    else piece.gather(st), pos, cfg, kind,
                                    piece)
        for name, t in new.items():
            if t is not st[name]:
                st[name].copy_(t if piece is None else piece.own(name, t))
    return unembed(params, x, cfg)[:, 0], state
