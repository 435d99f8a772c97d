"""Qwen2-VL-72B [arXiv:2409.12191] — VLM backbone with M-RoPE.

The ViT vision encoder is a stub: the model takes precomputed patch
embeddings scattered into the token stream, and the 3-stream (t, h, w)
M-RoPE position ids.
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    arch_type="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    block_pattern=(ATTN,),
    qkv_bias=True,
    mrope=True,
    rope_theta=1000000.0,
    act="silu",
    modality_frontend="vision",
    source="arXiv:2409.12191 (Qwen2-VL)",
)
