"""Sharding rules: parameter, input and decode-state specs for every
architecture (the port of ``repro.sharding.specs``, rule for rule).

Mesh axes: ``("data", "model")`` on one pod, ``("pod", "data", "model")``
across pods.  Strategy:

  * batch           -> ("pod", "data")   (pure DP over the pod axis)
  * weight matrices -> FSDP on the input dim over "data", the output dim
                       over "model"
  * vocab dims      -> "model"  (the Emb-PS analogue: CPR's unit of recovery)
  * MoE experts     -> "model" when divisible (expert parallel), else the
                       per-expert FFN dim
  * KV caches       -> kv heads over "model" when divisible; when the batch
                       does not divide, the cache *sequence* dim shards over
                       "data" (distributed attention over the cache)

Every rule is divisibility-guarded: a dim that does not divide its mesh
axis is left unsharded.

A spec is a ``P``: one entry per tensor dim, each ``None``, an axis name or
a tuple of axis names.  The rules read only a mesh's axis names and sizes,
so they take a ``torch.distributed`` ``DeviceMesh`` or a ``MeshShape``
stand-in (no process group).  ``to_placements`` turns a spec into the
``torch.distributed.tensor`` placements of a ``DeviceMesh`` (the port's
``to_shardings``); ``local_shape`` and ``shard_tree`` give a rank's shard,
``dim_range`` its index range along one dim; ``logits_spec`` is the
reference's dry run's spec of the prefill and serve steps' logits.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

from repro_torch.tree import tree_map, tree_map_with_path


class P:
    """A partition spec: a tuple of entries (``None``, an axis name or a
    tuple of names), one per tensor dim, trailing dims unsharded.  Not a
    ``tuple`` subclass, so the port's tree functions take it as a leaf."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        return isinstance(other, P) and self.entries == other.entries

    def __hash__(self):
        return hash(self.entries)

    def __repr__(self):
        return "P" + repr(self.entries)


class MeshShape(NamedTuple):
    """A mesh's axis names and sizes, without devices or a process group:
    what the rules read from a mesh."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or a ``MeshShape``."""
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    return dict(zip(names, tuple(mesh.shape)))


def axes_of(entry) -> tuple:
    """The axis names of one spec entry, in order (() for ``None``)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _axis_size(mesh, axis) -> int:
    sizes = axis_sizes(mesh)
    out = 1
    for a in axes_of(axis):
        out *= sizes[a]
    return out


def guard(mesh, shape, spec: P) -> P:
    """Drop any spec entry whose dim is not divisible by the axis size."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    return P(*(axis if axis and dim % _axis_size(mesh, axis) == 0 else None
               for dim, axis in zip(shape, entries)))


def batch_axes(mesh):
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


FSDP = "data"     # FSDP shards stay within a pod
TP = "model"


def _name(keys):
    return next((k for k in reversed(keys) if isinstance(k, str)), None)


def _mk(mesh, leaf, keys):
    """The rules' ``mk``: a spec over the leaf's own dims, with the stacked
    stages' leading (R,) axis unsharded, guarded."""
    stacked = "stages" in keys
    nd = leaf.ndim - (1 if stacked else 0)

    def mk(*spec):
        spec = spec + (None,) * (nd - len(spec))
        full = ((None,) + spec) if stacked else spec
        return guard(mesh, leaf.shape, P(*full))
    return mk, nd


def _lm_param_spec(path, leaf, mesh) -> P:
    """Rule table for transformer params keyed on the leaf's key path."""
    keys = list(path)
    name = keys[-1] if isinstance(keys[-1], str) else keys[-2]
    mk, nd = _mk(mesh, leaf, keys)

    if name in ("embed",):
        return mk(TP, FSDP)
    if name in ("lm_head",):
        return mk(FSDP, TP)
    if name == "wo" and "attn" in keys:             # attention out-proj
        return mk(TP, FSDP)
    if name in ("wq", "wk", "wv", "w_gate", "w_up", "w_x", "wog", "wi", "wf",
                "wz", "wo", "w_a", "w_i"):
        return mk(FSDP, TP)
    if name in ("wout", "w_down", "w_out"):
        return mk(TP, FSDP)
    if name in ("bq", "bk", "bv"):
        return mk(TP)
    if name == "router":
        return mk(FSDP, None)
    if name in ("rz", "ri", "rf", "ro"):           # sLSTM (H, hd, hd)
        return mk(None, None, TP)
    if name == "conv_w":
        return mk(None, TP)
    if name in ("log_lambda", "b_a", "b_i", "conv_b"):
        return mk(TP)
    if isinstance(name, str) and name.startswith("b"):
        return mk(None)
    if name in ("scale", "bias"):
        return mk(None)
    return mk(*([None] * nd))


def _moe_param_spec(path, leaf, mesh, num_experts: int) -> P:
    keys = list(path)
    name = _name(keys)
    mk, nd = _mk(mesh, leaf, keys)
    ep = num_experts % _axis_size(mesh, TP) == 0

    if name in ("w_gate", "w_up") and nd == 3:      # (E, d, f)
        return mk(TP, FSDP, None) if ep else mk(None, FSDP, TP)
    if name == "w_down" and nd == 3:                # (E, f, d)
        return mk(TP, None, FSDP) if ep else mk(None, TP, FSDP)
    return _lm_param_spec(path, leaf, mesh)


def lm_param_specs(params, cfg, mesh):
    """Spec tree matching a transformer param tree."""
    def rule(path, leaf):
        if cfg.moe is not None and "moe" in path:
            return _moe_param_spec(path, leaf, mesh, cfg.moe.num_experts)
        return _lm_param_spec(path, leaf, mesh)

    return tree_map_with_path(rule, params)


def lm_input_specs(batch_tree, mesh):
    """Shard every batch leaf's leading batch dim over (pod, data); M-RoPE's
    (3, B, S) positions on their axis 1."""
    dp = batch_axes(mesh)

    def rule(path, leaf):
        if "positions" in path and leaf.ndim == 3:
            return guard(mesh, leaf.shape, P(None, dp, None))
        return guard(mesh, leaf.shape, P(dp, *([None] * (leaf.ndim - 1))))

    return tree_map_with_path(rule, batch_tree)


def decode_state_specs(state_tree, cfg, mesh, batch: int):
    """Caches and recurrent states; stacked leaves carry a leading (R,) axis.

    kv caches (B, W, kv, hd): batch over dp when divisible; otherwise the
    sequence dim W shards over "data" (distributed cache attention) and kv
    heads over "model" when divisible.
    """
    dp = batch_axes(mesh)
    batch_shardable = batch % _axis_size(mesh, dp) == 0
    bdp = dp if batch_shardable else None

    def rule(path, leaf):
        keys = list(path)
        name = _name(keys)
        mk, nd = _mk(mesh, leaf, keys)

        if name in ("k", "v") and nd == 4:          # (B, W, kv, hd)
            kv = leaf.shape[-2]
            kv_ok = kv % _axis_size(mesh, TP) == 0
            if batch_shardable:
                # kv heads rarely divide the model axis: shard the cache
                # sequence over "model" instead
                return mk(dp, None, TP, None) if kv_ok else mk(dp, TP, None, None)
            return mk(None, FSDP, TP, None) if kv_ok else mk(None, (FSDP, TP), None, None)
        if name == "C" and nd == 4:                  # mLSTM (B, H, hd, hd)
            return mk(bdp, None, TP, None)
        if name in ("n",) and nd == 3:
            return mk(bdp, None, TP)
        if name in ("h", "c", "n", "m") and nd == 2:  # (B, w) / (B, d)
            return mk(bdp, TP)
        if name == "conv" and nd == 3:               # (B, K-1, w)
            return mk(bdp, None, TP)
        if nd >= 1:
            return mk(bdp)
        return mk()

    return tree_map_with_path(rule, state_tree)


def logits_spec(mesh, shape) -> P:
    """The logits' spec of the reference's dry run: (B, S, V) prefill
    logits ``P(dp, None, "model")``, (B, V) serve logits ``P(dp, "model")``,
    guarded (the batch entry drops where B does not divide over dp)."""
    dp = batch_axes(mesh)
    spec = P(dp, None, TP) if len(shape) == 3 else P(dp, TP)
    return guard(mesh, shape, spec)


def dlrm_param_specs(params, mesh):
    """DLRM: tables row-sharded over "model" (the Emb-PS partitioning),
    MLPs replicated (data-parallel trainers)."""
    def rule(path, leaf):
        if "tables" in path and leaf.ndim == 2:
            return guard(mesh, leaf.shape, P(TP, None))
        if "tables" in path and leaf.ndim == 1:      # rowwise adagrad acc
            return guard(mesh, leaf.shape, P(TP))
        return P(*([None] * leaf.ndim))

    return tree_map_with_path(rule, params)


# --------------------------------------------------------------------------
# a spec on a mesh: placements and a rank's shard
# --------------------------------------------------------------------------
def to_placements(spec: P, device_mesh) -> tuple:
    """The ``torch.distributed.tensor`` placements of ``spec`` on
    ``device_mesh``: one per mesh dim, ``Shard(d)`` where the spec puts
    tensor dim d on that mesh axis, else ``Replicate()``.

    One tensor dim over two mesh axes is ``Shard(d)`` on both.  DTensor
    splits a dim over its mesh dims in mesh-dim order, the leftmost the
    major one, so such an entry must name its axes in the mesh's order
    (every rule above does: ("pod", "data"), ("data", "model")); an entry
    in another order has no plain placement and raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(device_mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        idx = [names.index(a) for a in axes_of(entry)]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: dim {d}'s axes are not in the mesh's "
                             f"order {tuple(names)}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"{spec}: mesh axis {names[i]} used twice")
            out[i] = Shard(d)
    return tuple(out)


def local_shape(shape, spec: P, mesh) -> tuple:
    """A rank's shard of a tensor of ``shape`` under ``spec``."""
    out = list(shape)
    for d, entry in enumerate(spec):
        out[d] //= _axis_size(mesh, entry)
    return tuple(out)


def shard_index(entry, sizes: dict, coords: dict) -> int:
    """Which of the ``_axis_size`` chunks of a dim a rank holds: its
    coordinates over the entry's axes, the first axis the major one."""
    idx = 0
    for a in axes_of(entry):
        idx = idx * sizes[a] + coords[a]
    return idx


def dim_range(entry, local_n: int, sizes: dict, coords: dict) -> tuple:
    """The global index range [lo, hi) of a rank's ``local_n`` entries
    along a dim split over ``entry``'s axes (a KV cache's slots, its kv
    heads, a vocabulary)."""
    lo = shard_index(entry, sizes, coords) * local_n
    return lo, lo + local_n


def mesh_coords(device_mesh) -> dict:
    """{axis name: this rank's coordinate} on a ``DeviceMesh``."""
    return dict(zip(device_mesh.mesh_dim_names,
                    device_mesh.get_coordinate()))


def local_shard(t, spec: P, sizes: dict, coords: dict):
    """The view of a whole tensor ``t`` that the rank at ``coords`` holds."""
    for d, entry in enumerate(spec):
        n = 1
        for a in axes_of(entry):
            n *= sizes[a]
        if n > 1:
            chunk = t.shape[d] // n
            t = t.narrow(d, shard_index(entry, sizes, coords) * chunk, chunk)
    return t


def shard_tree(tree, spec_tree, device_mesh):
    """Each leaf's shard on this rank (contiguous copies), under the
    matching spec of ``spec_tree``."""
    sizes, coords = axis_sizes(device_mesh), mesh_coords(device_mesh)
    return tree_map(lambda t, s: local_shard(t, s, sizes, coords).contiguous(),
                    tree, spec_tree)
