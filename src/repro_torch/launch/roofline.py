"""Roofline terms of a step from the dry run's counts (the port of
``repro.launch.roofline``), with the H100's constants.

Three terms per (arch x shape x mesh), in seconds, per GPU:
  compute    = flops            / 989e12   (bf16 tensor cores, dense)
  memory     = bytes accessed   / 3.35e12  (HBM3)
  collective = collective bytes / the link's rate each way: NVLink 4
               (450e9) within an 8-GPU node, InfiniBand (50e9) once a
               mesh axis spans nodes

What the counts are (``launch.dryrun``), where the reference read them
from the compiled XLA module:
  * flops: ``torch.utils.flop_counter.FlopCounterMode`` over the rank's
    step on fake tensors: the product-class operations (matmul, bmm,
    einsum's products, attention's) of the plain versions only.  XLA
    counts every operation, so ``useful_flops_ratio`` here is the analytic
    6·N·D over the counted products, not over all work;
  * bytes accessed: every aten operation's operands and outputs, summed
    unfused (``BytesCounter``), an upper bound on what fused kernels move;
  * collective bytes: ``sharding.collectives.counts()``, the output bytes
    of every collective the rank issues (there is no HLO to parse, so the
    reference's ``collective_bytes`` has no port).

A probe runs one and two repetitions of the block pattern; the full depth
is extrapolated from their difference, as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch.mesh import HBM_BW, IB_BW, PEAK_FLOPS_BF16


class BytesCounter(TorchDispatchMode):
    """Sums the bytes of every aten operation's tensor operands and
    outputs (``bytes``), unfused; views move nothing and are skipped."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not _is_view(func):
            for t in _tensors((args, kwargs, out)):
                self.bytes += t.numel() * t.element_size()
        return out


def _is_view(func) -> bool:
    return any(a.alias_info is not None and not a.alias_info.is_write
               for a in func._schema.returns)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


@dataclass
class RooflineTerms:
    """All byte/flop quantities are PER GPU: the counts are of one rank's
    step."""
    flops: float               # per-GPU counted flops
    hbm_bytes: float           # per-GPU bytes accessed
    coll_bytes: float          # per-GPU collective payload bytes
    chips: int
    model_flops: float = 0.0   # analytic 6·N_active·D (global)
    link: str = "infiniband"   # the link the collective term is charged to
    link_bw: float = IB_BW

    @property
    def t_compute(self):
        return self.flops / PEAK_FLOPS_BF16

    @property
    def t_memory(self):
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self):
        return self.coll_bytes / self.link_bw

    @property
    def bottleneck(self):
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self):
        """MODEL_FLOPS / the GPUs' counted flops (products only, see the
        module docstring)."""
        return (self.model_flops / (self.flops * self.chips)
                if self.flops else 0.0)

    def as_dict(self):
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes, "chips": self.chips,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "collective_link": self.link,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
        }


def extrapolate(cost1: dict, cost2: dict, coll1: dict, coll2: dict,
                n_reps: int, rem_layers: int, pattern_len: int,
                chips: int, model_flops: float = 0.0,
                link=("infiniband", IB_BW)) -> RooflineTerms:
    """probe1 = 1 repetition, probe2 = 2 repetitions of the block pattern."""
    f1, f2 = cost1.get("flops", 0.0), cost2.get("flops", 0.0)
    b1 = cost1.get("bytes accessed", 0.0)
    b2 = cost2.get("bytes accessed", 0.0)
    c1, c2 = coll1["total"], coll2["total"]
    per_rep = (max(f2 - f1, 0.0), max(b2 - b1, 0.0), max(c2 - c1, 0.0))
    scale = (n_reps - 1) + rem_layers / pattern_len
    return RooflineTerms(
        flops=f1 + per_rep[0] * scale,
        hbm_bytes=b1 + per_rep[1] * scale,
        coll_bytes=c1 + per_rep[2] * scale,
        chips=chips, model_flops=model_flops, link=link[0],
        link_bw=link[1])


def analytic_model_flops(cfg, shape) -> float:
    """6·N_active·tokens for training; 2·N_active·tokens for inference."""
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * tokens
