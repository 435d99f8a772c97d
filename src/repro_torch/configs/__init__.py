"""Model configurations of the port (its own copies of ``repro.configs``).

``get_config(arch_id)`` / ``list_archs()`` cover the language models the
port runs: the Griffin and Gemma-2 families, the dense Qwen2,
Qwen2.5 and Phi-3 models, the Qwen MoE models, Qwen2-VL (M-RoPE, patch
embeddings), HuBERT (an audio encoder) and xLSTM (mLSTM and sLSTM
blocks): every language model of the reference.  The DLRM configurations
live in ``configs.dlrm``; ``get_dlrm_config(dataset)`` names them.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (INPUT_SHAPES, InputShape, ModelConfig,
                                      MoEConfig)

_MODULES = {
    "recurrentgemma-2b": "recurrentgemma_2b",
    "gemma2-2b": "gemma2_2b",
    "phi3-medium-14b": "phi3_medium_14b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "qwen2-7b": "qwen2_7b",
    "qwen2.5-14b": "qwen2_5_14b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "hubert-xlarge": "hubert_xlarge",
    "xlstm-1.3b": "xlstm_1_3b",
}


def list_archs():
    return sorted(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list_archs()}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def get_dlrm_config(dataset: str = "kaggle"):
    from repro_torch.configs.dlrm import DLRM_KAGGLE, DLRM_TERABYTE
    return {"kaggle": DLRM_KAGGLE, "terabyte": DLRM_TERABYTE}[dataset]


__all__ = ["get_config", "get_dlrm_config", "list_archs", "ModelConfig",
           "MoEConfig", "InputShape", "INPUT_SHAPES"]
