"""DLRM (Naumov et al., arXiv:1906.00091) — the paper's workload, in PyTorch.

Dense features -> bottom MLP; sparse categorical features -> embedding-bag
lookups (sum pooling); pairwise dot-product feature interaction; top MLP ->
CTR logit.  The parameter layout is the reference's
(``repro.models.dlrm``): ``{"tables": [(N, d)], "bottom": [{"w", "b"}],
"top": [{"w", "b"}]}`` with ``w`` of shape (in, out) applied as ``x @ w``.

The embedding lookups of all tables go through one
``kernels.ops.embedding_bags`` call: the tables' device picks the CUDA
kernel (one launch forward, one backward) or its plain version, so there
is no ``use_kernel`` switch.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.dlrm import DLRMConfig  # noqa: F401  (re-export)
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init
from repro_torch.tree import params_from_jax  # noqa: F401  (re-export)
from repro_torch.tree import tree_map


def init_mlp_stack(sizes, generator, device):
    """``dense_init`` (uniform in ±1/sqrt(fan_in)) weights, zero biases."""
    return [{"w": dense_init(generator, (a, b), device=device),
             "b": torch.zeros(b, dtype=torch.float32, device=device)}
            for a, b in zip(sizes[:-1], sizes[1:])]


def init_dlrm(cfg: DLRMConfig, generator=None, device=None) -> dict:
    """Random parameters from the reference's distributions (tables uniform
    in ±1/sqrt(n)).  The numbers differ from jax's; carry the reference's
    own across with ``params_from_jax`` where they must match."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    tables = [dense_init(generator, (n, cfg.emb_dim), device=device)
              for n in cfg.table_sizes]
    return {
        "tables": tables,
        "bottom": init_mlp_stack((cfg.num_dense,) + cfg.bottom_mlp,
                                 generator, device),
        "top": init_mlp_stack((cfg.interaction_dim,) + cfg.top_mlp,
                              generator, device),
    }


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
    embs = ops.embedding_bags(params["tables"], batch["sparse"])  # (B, T, emb)
    feats = torch.cat([dense_out[:, None], embs], dim=1)           # (B, F, emb)
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
