"""RecurrentGemma-2B [arXiv:2402.19427] — Griffin: RG-LRU + local attention, 1:2."""
from repro_torch.configs.base import LOCAL_ATTN, RECURRENT, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    arch_type="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,           # MQA
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    block_pattern=(RECURRENT, RECURRENT, LOCAL_ATTN),
    sliding_window=2048,
    rglru_width=2560,
    conv1d_width=4,
    rope_theta=10000.0,
    act="silu",
    tie_embeddings=True,
    source="arXiv:2402.19427 (RecurrentGemma / Griffin)",
)
