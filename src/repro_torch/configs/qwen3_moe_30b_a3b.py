"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B] — 128 routed experts, top-8."""
from repro_torch.configs.base import MOE, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    arch_type="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=0,
    vocab_size=151936,
    block_pattern=(MOE,),
    moe=MoEConfig(num_experts=128, top_k=8, d_expert=768),
    rope_theta=1000000.0,
    act="silu",
    source="hf:Qwen/Qwen3-30B-A3B",
)
