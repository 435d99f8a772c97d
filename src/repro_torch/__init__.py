"""PyTorch/CUDA port of the CPR reproduction (the JAX package ``repro``
is the reference it is held against).

Module paths mirror ``src/repro/``.  The port imports ``torch`` and
numpy only: never ``jax`` and nothing of ``repro``.

Device rule: every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``.  Without a GPU and without an explicit ``"cpu"`` it
raises; it never carries on quietly on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``.  A CUDA device without a visible GPU raises.

    Picking CUDA also turns TF32 off for matmuls and cuDNN, and reduced-
    precision (bf16) reductions in cuBLAS's split-K bf16 matmuls: the
    reference runs its f32 matmuls in full f32 and sums its bf16 matmuls
    in f32, so the port does too."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
