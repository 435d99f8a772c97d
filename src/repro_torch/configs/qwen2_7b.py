"""Qwen2-7B [arXiv:2407.10671] — dense GQA with QKV bias."""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    arch_type="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    block_pattern=(ATTN,),
    qkv_bias=True,
    rope_theta=1000000.0,
    act="silu",
    source="arXiv:2407.10671 (Qwen2)",
)
