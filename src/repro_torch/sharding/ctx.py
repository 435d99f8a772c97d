"""Activation-sharding context (the port of ``repro.sharding.ctx``).

Model code is mesh-agnostic; the launch layer installs a policy with
``activation_sharding(mesh)`` (thread-local, restored on exit).
``constrain_spec(shape, kind)`` is the reference's choice of spec for an
activation of that shape and kind (``None`` where the reference leaves it
alone, or outside any policy).

Kinds:
  activation  (B, S, d)    -> batch over (pod, data)
  logits      (B, S, V)    -> batch over dp, vocab over model
  residual    (B, S, d)    -> batch over dp, d over model
  moe_dispatch(E, C, d)    -> experts over model (EP) or d over model
  moe_flat    (E*C, d)     -> the same on the flat buffer
  tokens_flat (T, d)       -> token dim over dp

Where the reference's ``constrain`` is a ``with_sharding_constraint`` that
the SPMD partitioner honours, the port's ranks each hold their batch
shard and gather each layer's weights whole (``launch.steps``), so a plain
tensor has nothing to reshard: ``constrain`` returns it unchanged.  On a
``DTensor`` it redistributes to the placements of ``constrain_spec``.

Two port modules read the policy where it changes what they compute:
``models.xlstm.mlstm_forward`` (``probe_full_blocks``: one chunk of the
whole sequence, for the dry run's probes) and ``models.moe.apply_moe_auto``
(the expert-parallel path when the model axis has more than one rank).
The reference's other readers, the blocked jnp attention of
``repro.models.layers`` (``_block_causal_sdpa`` and ``_chunked_sdpa``),
have no counterpart: the port's attention is always
``ops.flash_attention`` or its plain version, which has no blocks to
probe.

A sharded step of ``launch.steps`` installs its rank's shards as well
(``rank_shards``); the models read them with ``current_shards()`` where a
rank computes on its piece: ``models.transformer`` looks tokens up in the
rank's vocabulary slice and hands each decode layer its ``StatePiece``.
"""
from __future__ import annotations

import contextlib
import threading

from repro_torch.sharding.specs import P, axis_sizes, batch_axes, to_placements

_tls = threading.local()


def current_policy():
    return getattr(_tls, "policy", None)


def current_shards():
    """The rank's shards of the sharded step running on this thread
    (``launch.steps._Shards``), or None."""
    return getattr(_tls, "shards", None)


@contextlib.contextmanager
def rank_shards(shards):
    """Install a sharded step's ``shards`` (thread-local, restored on
    exit)."""
    old = current_shards()
    _tls.shards = shards
    try:
        yield shards
    finally:
        _tls.shards = old


@contextlib.contextmanager
def activation_sharding(mesh, moe_expert_parallel: bool = True,
                        probe_full_blocks: bool = False,
                        batch_sharded: bool = True):
    """Install the policy for ``mesh``.  ``batch_sharded`` (port only): the
    ranks hold their own shard of the batch over the dp axes (the input
    specs' guard held), rather than all of it."""
    sizes = axis_sizes(mesh)
    policy = {
        "mesh": mesh,
        "dp": batch_axes(mesh),
        "dp_size": sizes.get("data", 1) * sizes.get("pod", 1),
        "tp_size": sizes.get("model", 1),
        "moe_ep": moe_expert_parallel,
        # roofline probes: blocked scans (the mLSTM's chunks) run as one
        # block; the math is identical
        "probe_full_blocks": probe_full_blocks,
        "batch_sharded": batch_sharded,
    }
    old = current_policy()
    _tls.policy = policy
    try:
        yield policy
    finally:
        _tls.policy = old


def _fits(dim, size):
    return dim % size == 0


def constrain_spec(shape, kind: str):
    """The reference's spec for an activation of ``shape`` and ``kind``
    under the installed policy, or ``None`` (no policy, or a kind and rank
    it leaves alone)."""
    pol = current_policy()
    if pol is None:
        return None
    dp, dps, tps = pol["dp"], pol["dp_size"], pol["tp_size"]
    nd = len(shape)
    bdp = dp if nd and _fits(shape[0], dps) else None
    if kind == "activation" and nd >= 2:
        return P(bdp, *([None] * (nd - 1)))
    if kind == "logits" and nd == 3:
        return P(bdp, None, "model" if _fits(shape[2], tps) else None)
    if kind == "tokens_flat" and nd == 2:
        return P(bdp, None)
    if kind == "residual" and nd == 3:
        return P(bdp, None, "model" if _fits(shape[2], tps) else None)
    if kind == "moe_dispatch" and nd == 3:
        if pol["moe_ep"] and _fits(shape[0], tps):
            return P("model", None, None)
        return P(None, None, "model" if _fits(shape[2], tps) else None)
    if kind == "moe_flat" and nd == 2:
        if pol["moe_ep"] and _fits(shape[0], tps):
            return P("model", None)
        return P(None, "model" if _fits(shape[1], tps) else None)
    return None


def constrain(x, kind: str):
    """``x`` unchanged, unless it is a ``DTensor`` and the policy has a
    spec for it: then ``x`` redistributed to that spec's placements."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    spec = constrain_spec(tuple(x.shape), kind)
    if spec is None:
        return x
    return x.redistribute(x.device_mesh, to_placements(spec, x.device_mesh))
