"""Qwen2.5-14B [hf:Qwen/Qwen2.5-0.5B family card] — dense GQA with QKV bias."""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    arch_type="dense",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    vocab_size=152064,
    block_pattern=(ATTN,),
    qkv_bias=True,
    rope_theta=1000000.0,
    act="silu",
    source="hf:Qwen/Qwen2.5 model cards",
)
