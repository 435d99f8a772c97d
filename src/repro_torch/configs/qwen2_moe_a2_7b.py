"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B] — 60 routed experts top-4 + 4 shared."""
from repro_torch.configs.base import MOE, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    arch_type="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=0,                    # FFN is the MoE
    vocab_size=151936,
    block_pattern=(MOE,),
    moe=MoEConfig(num_experts=60, top_k=4, d_expert=1408,
                  num_shared_experts=4, d_shared=5632),
    qkv_bias=True,
    rope_theta=1000000.0,
    act="silu",
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)
