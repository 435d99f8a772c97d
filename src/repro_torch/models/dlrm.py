"""DLRM (Naumov et al., arXiv:1906.00091) — the paper's workload, in PyTorch.

Dense features -> bottom MLP; sparse categorical features -> embedding-bag
lookups (sum pooling); pairwise dot-product feature interaction; top MLP ->
CTR logit.  The parameter layout is the reference's
(``repro.models.dlrm``): ``{"tables": [(N, d)], "bottom": [{"w", "b"}],
"top": [{"w", "b"}]}`` with ``w`` of shape (in, out) applied as ``x @ w``.

The embedding lookup goes through ``kernels.ops.embedding_bag``: the
tables' device picks the CUDA kernel or its plain version, so there is
no ``use_kernel`` switch.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.dlrm import DLRMConfig  # noqa: F401  (re-export)
from repro_torch.kernels import ops
from repro_torch.tree import tree_map


def _uniform(shape, scale, generator, device):
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return u.mul_(2 * scale).sub_(scale)


def init_mlp_stack(sizes, generator, device):
    """``dense_init`` (uniform in ±1/sqrt(fan_in)) weights, zero biases."""
    return [{"w": _uniform((a, b), 1.0 / math.sqrt(max(a, 1)), generator,
                           device),
             "b": torch.zeros(b, dtype=torch.float32, device=device)}
            for a, b in zip(sizes[:-1], sizes[1:])]


def init_dlrm(cfg: DLRMConfig, generator=None, device=None) -> dict:
    """Random parameters from the reference's distributions (tables uniform
    in ±1/sqrt(n)).  The numbers differ from jax's; carry the reference's
    own across with ``params_from_jax`` where they must match."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    tables = [_uniform((n, cfg.emb_dim), 1.0 / math.sqrt(n), generator,
                       device) for n in cfg.table_sizes]
    return {
        "tables": tables,
        "bottom": init_mlp_stack((cfg.num_dense,) + cfg.bottom_mlp,
                                 generator, device),
        "top": init_mlp_stack((cfg.interaction_dim,) + cfg.top_mlp,
                              generator, device),
    }


def params_from_jax(tree, device=None) -> dict:
    """The reference's ``init_dlrm`` output, as numpy arrays, on ``device``."""
    device = resolve_device(device)
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=device),
                    tree)


def params_to_numpy(params) -> dict:
    """Host copies of every leaf (never aliasing the live tensors)."""
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), params)


def apply_mlp_stack(ws, x, final_act=True):
    for i, p in enumerate(ws):
        x = x @ p["w"] + p["b"]
        if i < len(ws) - 1 or final_act:
            x = torch.relu(x)
    return x


def dlrm_forward(params, batch, cfg: DLRMConfig) -> torch.Tensor:
    """batch: dense (B, num_dense) f32; sparse (B, num_sparse, multi_hot)
    int32 tensors.  Returns CTR logits (B,)."""
    dense_out = apply_mlp_stack(params["bottom"], batch["dense"])  # (B, emb)
    sparse = batch["sparse"]
    embs = [ops.embedding_bag(t, sparse[:, i, :].contiguous())
            for i, t in enumerate(params["tables"])]
    feats = torch.stack([dense_out] + embs, dim=1)                 # (B, F, emb)
    inter = torch.bmm(feats, feats.transpose(1, 2))                # (B, F, F)
    f = feats.shape[1]
    iu, ju = torch.triu_indices(f, f, 1, device=feats.device)      # row-major
    pairwise = inter[:, iu, ju]                                    # (B, F(F-1)/2)
    z = torch.cat([dense_out, pairwise], dim=-1)
    return apply_mlp_stack(params["top"], z, final_act=False)[:, 0]


def dlrm_loss(params, batch, cfg: DLRMConfig):
    logits = dlrm_forward(params, batch, cfg)
    y = batch["label"].to(torch.float32)
    # numerically-stable BCE with logits, written as the reference writes it
    loss = torch.mean(torch.clamp_min(logits, 0) - logits * y +
                      torch.log1p(torch.exp(-torch.abs(logits))))
    return loss, logits


def batch_to(batch, device) -> dict:
    """A dataset batch (numpy) as tensors on ``device``."""
    return {"dense": torch.as_tensor(batch["dense"], device=device),
            "sparse": torch.as_tensor(batch["sparse"], device=device),
            "label": torch.as_tensor(batch["label"], device=device)}
