"""Phi-3-medium 14B [arXiv:2404.14219] — dense, RoPE, SwiGLU, GQA."""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    arch_type="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    head_dim=128,
    d_ff=17920,
    vocab_size=100352,
    block_pattern=(ATTN,),
    rope_theta=10000.0,
    act="silu",
    source="arXiv:2404.14219 (Phi-3 technical report)",
)
