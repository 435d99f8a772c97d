"""Model configurations of the port (its own copies of ``repro.configs``).

``get_config(arch_id)`` / ``list_archs()`` cover the language models the
port runs so far; the reference's other eight architectures come with
their slices.  The DLRM configurations live in ``configs.dlrm``.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (INPUT_SHAPES, InputShape, ModelConfig,
                                      MoEConfig)

_MODULES = {
    "recurrentgemma-2b": "recurrentgemma_2b",
    "gemma2-2b": "gemma2_2b",
}


def list_archs():
    return sorted(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list_archs()}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


__all__ = ["get_config", "list_archs", "ModelConfig", "MoEConfig",
           "InputShape", "INPUT_SHAPES"]
