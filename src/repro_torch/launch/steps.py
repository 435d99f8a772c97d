"""Step builders: the train, prefill and serve steps with their specs, and
shape-only stand-ins for the dry run (the port of ``repro.launch.steps``).

``build_*`` return the reference's tuples: the step function, the
parameter (and state) structs, and their spec trees.  A struct is a
``FakeTensor`` (``torch._subclasses.fake_tensor``): it has a shape and a
dtype and allocates nothing.  The reference's ``use_flash`` has no
counterpart: the tensors' device picks the attention route.

``shard_train_step``, ``shard_prefill_step`` and ``shard_serve_step`` are
the counterparts of ``jax.jit(step, in_shardings=..., out_shardings=...)``
on a mesh: the step of one rank on its shards.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import torch

from repro_torch.configs.base import INPUT_SHAPES, ModelConfig
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import apply_updates, get_optimizer
from repro_torch.sharding import collectives as coll
from repro_torch.sharding import specs as S
from repro_torch.sharding.ctx import (activation_sharding, current_policy,
                                      current_shards, rank_shards)
from repro_torch.tree import leaves, tree_map, tree_map_with_path, unflatten


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode()


# --------------------------------------------------------------------------
# shape-only stand-ins
# --------------------------------------------------------------------------
def batch_struct(cfg: ModelConfig, shape_name: str) -> Dict[str, Any]:
    """Model-input structs for a (cfg, input-shape) pair."""
    shp = INPUT_SHAPES[shape_name]
    B, Sq = shp.global_batch, shp.seq_len
    i32 = torch.int32
    dt = getattr(torch, cfg.dtype)
    with _fake_mode():
        if shp.kind == "decode":
            return {"tokens": torch.empty((B,), dtype=i32)}
        batch: Dict[str, Any] = {}
        if cfg.modality_frontend == "audio":
            batch["embeds"] = torch.empty((B, Sq, cfg.d_model), dtype=dt)
            if shp.kind == "train":
                batch["targets"] = torch.empty((B, Sq), dtype=i32)
                batch["target_mask"] = torch.empty((B, Sq),
                                                   dtype=torch.float32)
        else:
            batch["tokens"] = torch.empty((B, Sq), dtype=i32)
            if cfg.modality_frontend == "vision":
                Pn = Sq // 4  # quarter of the context is image patches
                batch["patch_embeds"] = torch.empty((B, Pn, cfg.d_model),
                                                    dtype=dt)
                batch["patch_positions"] = torch.empty((B, Pn), dtype=i32)
                batch["positions"] = torch.empty((3, B, Sq), dtype=i32)
        return batch


@functools.lru_cache(maxsize=16)
def param_structs(cfg: ModelConfig):
    """Parameter structs: ``init_model`` on fake CPU tensors (no
    allocation); one tree a config, shared by its callers (read only)."""
    with _fake_mode():
        return T.init_model(cfg, torch.Generator().manual_seed(0), "cpu")


def _cast_struct(tree, dtype):
    return tree_map(lambda s: s.to(dtype) if s.is_floating_point() else s,
                    tree)


# --------------------------------------------------------------------------
# a rank's view of a sharded step
# --------------------------------------------------------------------------
_EXPERTS = ("w_gate", "w_up", "w_down")
_VOCAB = ("embed", "lm_head")


def _paths(spec_tree) -> dict:
    out = {}
    tree_map_with_path(lambda path, s: out.__setitem__(path, s), spec_tree)
    return out


class _Shards:
    """The mesh and the specs of a sharded step: gathers a rank's parameter
    shards for the forward and sums their gradients (train); keeps the
    vocabulary split (``vocab_local``: prefill and serve, whose logits are
    the rank's slice) and gives each decode layer its ``StatePiece``
    (``s_spec``: serve)."""

    def __init__(self, mesh, p_spec, b_spec=None, s_spec=None,
                 vocab_local=False):
        self.mesh = mesh
        self.sizes = S.axis_sizes(mesh)
        self.coords = S.mesh_coords(mesh)
        self.world = 1
        for n in self.sizes.values():
            self.world *= n
        self.specs = _paths(p_spec)
        self.b_specs = {} if b_spec is None else _paths(b_spec)
        self.s_specs = {} if s_spec is None else _paths(s_spec)
        self.vocab_local = vocab_local
        self._pieces = {}

    def _keep(self, path, spec):
        """MoE experts split over "model" stay the rank's own: the expert-
        parallel layer exchanges tokens instead of weights.  (The shared
        expert's MLP, ``moe/shared/...``, is gathered whole.)  With
        ``vocab_local`` the vocabulary dim of ``embed`` and ``lm_head``
        keeps its axes."""
        stacked = path[0] == "stages"
        if (len(path) > 1 and path[-2] == "moe" and path[-1] in _EXPERTS
                and spec[1 if stacked else 0] == S.TP):
            return (S.TP,)
        if self.vocab_local and path[-1] in _VOCAB:
            return S.axes_of(spec[0 if path[-1] == "embed" else 1])
        return ()

    def materialize(self, params):
        """The parameters the forward reads: each stage leaf a
        ``ShardedStack`` (gathered a layer at a time by ``_layer``), every
        other leaf gathered whole once (but over ``_keep``)."""
        def one(path, t):
            spec = self.specs[path]
            keep = self._keep(path, spec)
            if path[0] == "stages":
                return coll.ShardedStack(t, spec, self.mesh, keep)
            return coll.gather(t, spec, self.mesh, keep)
        return tree_map_with_path(one, params)

    def vocab_piece(self, rows: int):
        """(lo, axes, mesh) of the rank's slice of ``embed``'s vocabulary,
        its ``rows`` rows from row lo, where ranks split it, else None."""
        if not self.vocab_local or ("embed",) not in self.specs:
            return None
        axes = tuple(a for a in S.axes_of(self.specs[("embed",)][0])
                     if self.sizes[a] > 1)
        if not axes:
            return None
        lo, _ = S.dim_range(axes, rows, self.sizes, self.coords)
        return lo, axes, self.mesh

    def state_piece(self, path):
        """The ``StatePiece`` of the layer whose state leaves sit at
        ``path`` (``("stages", j)`` or ``("rest", i)``)."""
        if path not in self._pieces:
            cut = 1 if path[0] == "stages" else 0
            specs = {p[-1]: S.P(*list(s)[cut:])
                     for p, s in self.s_specs.items() if p[:-1] == path}
            self._pieces[path] = coll.StatePiece(specs, self.mesh)
        return self._pieces[path]

    def reduce_grads(self, grads):
        """The gradient of the mean of the ranks' losses: each shard's sum
        over the ranks (over its spec's axes the gathers' reduce-scatters
        summed it; the other axes are all-reduced here), over the world."""
        names = tuple(self.sizes)

        def one(path, g):
            named = {a for e in self.specs[path] for a in S.axes_of(e)}
            free = tuple(a for a in names if a not in named)
            return coll.all_reduce(g, self.mesh, free) / self.world
        return tree_map_with_path(one, grads)

    def split_batch(self, batch, microbatches: int):
        """The rank's parts of the reference's microbatches: the global
        batch cut into ``microbatches`` consecutive parts (``_split``), and
        the rank's shard of each under the batch spec.  Cutting the rank's
        own shard instead would put other rows together in a microbatch,
        and an MoE layer's capacity would keep other assignments.  Each
        leaf is gathered whole once."""
        cut = {}

        def one(path, a):
            spec = self.b_specs[path]
            with torch.no_grad():
                whole = coll.gather(a, spec, self.mesh)
            cut[path] = [S.local_shard(part, spec, self.sizes, self.coords)
                         for part in whole.chunk(microbatches,
                                                 dim=_batch_axis(path, a))]
        tree_map_with_path(one, batch)
        return [tree_map_with_path(lambda path, a: cut[path][i], batch)
                for i in range(microbatches)]

    def mean(self, t):
        """A metric averaged over every rank."""
        return coll.all_reduce(t.detach(), self.mesh,
                               tuple(self.sizes)) / self.world


# --------------------------------------------------------------------------
# step builders
# --------------------------------------------------------------------------
def _batch_axis(path, a) -> int:
    """A batch leaf's batch axis: 1 for M-RoPE's (3, B, S) positions."""
    return 1 if (path[-1] == "positions" and a.ndim == 3
                 and a.shape[0] == 3) else 0


def _split(batch, microbatches: int):
    """The batch cut into ``microbatches`` consecutive parts of its batch
    axis; in a sharded step, the rank's shards of the global batch's
    parts (``_Shards.split_batch``)."""
    shards = current_shards()
    if shards is not None:
        return shards.split_batch(batch, microbatches)

    def part(i):
        return tree_map_with_path(
            lambda path, a: a.chunk(microbatches,
                                    dim=_batch_axis(path, a))[i], batch)

    return [part(i) for i in range(microbatches)]


def build_train_step(cfg: ModelConfig, mesh, optimizer="adam", lr=3e-4,
                     param_dtype=torch.float32, bf16_forward=True,
                     microbatches: int = 1):
    """-> (train_step, p_struct, o_struct, p_spec, o_spec).

    ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: with ``bf16_forward`` the f32 masters are cast to bf16
    before use (before a sharded step's gathers, which then move half the
    bytes) and the gradients flow back through the cast to f32;
    ``lm_loss`` with remat; ``microbatches`` parts of the batch each
    through forward and backward, their gradients summed and averaged;
    then the optimizer's update, in place.  ``metrics``: ``loss`` (with
    the aux loss), ``nll``, ``aux``."""
    opt = get_optimizer(optimizer, lr)

    def loss_fn(p, b):
        if bf16_forward:
            p = tree_map(lambda a: a.to(torch.bfloat16)
                         if a.dtype == torch.float32 else a, p)
        shards = current_shards()
        if shards is not None:
            p = shards.materialize(p)
        return T.lm_loss(p, b, cfg, remat=True)

    def train_step(params, opt_state, batch):
        # each microbatch's backward sums its gradients into the leaves'
        # .grad: 1/M of the activations at the same total work, and no
        # second gradient tree
        ps = [t.detach().requires_grad_(True) for t in leaves(params)]
        p = unflatten(params, ps)
        parts = _split(batch, microbatches) if microbatches > 1 else [batch]
        l_acc, nlls, auxs = 0.0, [], []
        for b in parts:
            loss, (nll, aux) = loss_fn(p, b)
            loss.backward()
            l_acc = l_acc + loss.detach()
            nlls.append(nll.detach())
            auxs.append(aux.detach())
        grads = [torch.zeros_like(t) if t.grad is None
                 else t.grad.div_(microbatches) for t in ps]
        del p, ps
        metrics = {"loss": l_acc / microbatches,
                   "nll": torch.stack(nlls).mean(),
                   "aux": torch.stack(auxs).mean()}
        grads = unflatten(params, grads)
        shards = current_shards()
        if shards is not None:
            grads = shards.reduce_grads(grads)
            metrics = {k: shards.mean(v) for k, v in metrics.items()}
        updates, opt_state = opt.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        return params, opt_state, metrics

    p_struct = _cast_struct(param_structs(cfg), param_dtype)
    o_struct = opt.init(p_struct)
    p_spec = S.lm_param_specs(p_struct, cfg, mesh)
    o_spec = _opt_specs(o_struct, p_spec)
    return train_step, p_struct, o_struct, p_spec, o_spec


def _opt_specs(o_struct, p_spec):
    """Optimizer-state specs, structure-exact: adam m/v mirror the params;
    scalars replicate; row-wise accumulators take the param's row axis."""
    out = {}
    if "m" in o_struct:
        out["m"] = p_spec
        out["v"] = p_spec
        out["t"] = S.P()
    if "mu" in o_struct:
        out["mu"] = p_spec
    if "acc" in o_struct:
        def row_rule(spec, acc_leaf):
            if acc_leaf.ndim == 1 and len(spec) >= 1:
                return S.P(spec[0])
            return spec
        out["acc"] = tree_map(row_rule, p_spec, o_struct["acc"])
    return out


def shard_train_step(train_step, mesh, p_spec, o_spec, b_spec):
    """The train step of this rank of ``mesh`` (the counterpart of
    ``jax.jit(train_step, in_shardings=(p_spec, o_spec, b_spec))``).

    The returned ``step(params, opt_state, batch)`` takes and returns the
    rank's shards (``specs.shard_tree``) of the parameters and optimizer
    state, and takes its shard of the batch.  In the forward each stage's
    leaves are gathered a layer at a time over the axes their spec names,
    inside the layer's remat region, and the other leaves (``embed``,
    ``lm_head``, ``final_norm``, ``rest``) once; MoE experts split over
    "model" stay local (``models.moe.apply_moe_shard_map``).  The backward
    reduce-scatters each gradient to its spec; the step sums it over the
    axes the spec does not name and divides by the world: the gradient of
    the mean of the ranks' losses (each the mean over its own tokens, so
    the global mean where every rank has as many tokens as the next: a
    causal LM's batch, not an encoder's ``target_mask``).  The optimizer
    then updates the local shards (elementwise: Adam, SGD; a row-wise
    accumulator over a sharded row raises).  Unless a policy is installed
    the step runs under ``activation_sharding(mesh)``; the metrics are the
    ranks' mean."""
    if "acc" in o_spec:
        for spec in leaves(p_spec):
            if any(S.axes_of(e) for e in list(spec)[1:]):
                raise ValueError("row-wise accumulators over rows split "
                                 f"across ranks ({spec}) are not supported")
    # the input specs shard every leaf's batch axis, or none (one guard)
    batch_sharded = any(S.axes_of(e) for spec in leaves(b_spec)
                        for e in spec)
    return _on_rank(train_step, _Shards(mesh, p_spec, b_spec), mesh,
                    batch_sharded)


def _on_rank(fn, shards, mesh, batch_sharded: bool):
    """``fn`` run with the rank's ``shards`` installed, under
    ``activation_sharding(mesh, batch_sharded=...)`` unless a policy is
    installed already."""
    def step(*args):
        with rank_shards(shards):
            if current_policy() is None:
                with activation_sharding(mesh, batch_sharded=batch_sharded):
                    return fn(*args)
            return fn(*args)

    return step


def shard_prefill_step(prefill_step, mesh, p_spec, b_spec):
    """The prefill step of this rank of ``mesh`` (the counterpart of
    ``jax.jit(prefill_step, in_shardings=(p_spec, b_spec),
    out_shardings=specs.logits_spec(...))``).

    The returned ``step(params, batch)`` takes the rank's shards of the
    parameters and of the batch and returns its shard of the logits under
    ``specs.logits_spec``: (B / dp, S, V / model) where those divide.  The
    weights are gathered as ``shard_train_step`` gathers them (a layer at
    a time; MoE experts split over "model" stay local), but for the
    vocabulary of ``embed`` and ``lm_head``, which stays split: each rank
    looks its tokens up in its slice (``transformer._embed``) and computes
    only its slice of the logits."""
    batch_sharded = any(S.axes_of(e) for spec in leaves(b_spec)
                        for e in spec)
    return _on_rank(prefill_step, _Shards(mesh, p_spec, vocab_local=True),
                    mesh, batch_sharded)


def shard_serve_step(serve_step, mesh, p_spec, s_spec):
    """The serve step of this rank of ``mesh`` (the counterpart of
    ``jax.jit(serve_step, in_shardings=(p_spec, s_spec, tokens, None),
    out_shardings=(logits, s_spec))``).

    The returned ``step(params, state, tokens, pos)`` takes the rank's
    shards of the parameters and of the decode state (``specs.shard_tree``
    under ``s_spec``, ``decode_state_specs``) and its tokens: their shard
    under P(dp) where the batch divides over dp, else all of them.  It
    returns the rank's slice of the logits (``specs.logits_spec``) and the
    state, its shards updated in place.  The weights are gathered as
    ``shard_prefill_step`` gathers them; each attention layer attends over
    the rank's piece of its KV cache and merges the pieces
    (``models.layers.attention_decode``), and each recurrent state is
    gathered for its layer and cut back to the rank's slice
    (``models.transformer.decode_step``).  Where the batch does not
    divide, every rank computes the same tokens, bit for bit."""
    specs = _paths(s_spec)
    batch_sharded = any(S.axes_of(spec[1 if path[0] == "stages" else 0])
                        for path, spec in specs.items())
    return _on_rank(serve_step, _Shards(mesh, p_spec, s_spec=s_spec,
                                        vocab_local=True),
                    mesh, batch_sharded)


def build_prefill_step(cfg: ModelConfig, mesh, param_dtype=None):
    """-> (prefill_step, p_struct, p_spec); ``prefill_step(params, batch)``
    gives the logits (in a sharded step the rank's shards in and out:
    ``shard_prefill_step``)."""
    def prefill_step(params, batch):
        shards = current_shards()
        if shards is not None:
            params = shards.materialize(params)
        logits, _ = T.forward(params, batch, cfg)
        return logits

    p_struct = param_structs(cfg)
    if param_dtype is not None:
        p_struct = _cast_struct(p_struct, param_dtype)
    p_spec = S.lm_param_specs(p_struct, cfg, mesh)
    return prefill_step, p_struct, p_spec


def build_serve_step(cfg: ModelConfig, mesh, shape_name: str,
                     param_dtype=None):
    """-> (serve_step, p_struct, s_struct, p_spec, s_spec);
    ``serve_step(params, state, tokens, pos) -> (logits, state)``, the
    state updated in place (in a sharded step the rank's shards:
    ``shard_serve_step``)."""
    shp = INPUT_SHAPES[shape_name]
    B, Sq = shp.global_batch, shp.seq_len

    def serve_step(params, state, tokens, pos):
        shards = current_shards()
        if shards is not None:
            params = shards.materialize(params)
        return T.decode_step(params, state, tokens, pos, cfg)

    p_struct = param_structs(cfg)
    if param_dtype is not None:
        p_struct = _cast_struct(p_struct, param_dtype)
    with _fake_mode():
        s_struct = T.init_decode_state(cfg, B, Sq, getattr(torch, cfg.dtype),
                                       "cpu")
    p_spec = S.lm_param_specs(p_struct, cfg, mesh)
    s_spec = S.decode_state_specs(s_struct, cfg, mesh, B)
    return serve_step, p_struct, s_struct, p_spec, s_spec
