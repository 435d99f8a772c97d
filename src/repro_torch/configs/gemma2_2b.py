"""Gemma-2 2B [arXiv:2408.00118] — alternating local/global attention, softcaps."""
from repro_torch.configs.base import ATTN, LOCAL_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    arch_type="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    block_pattern=(LOCAL_ATTN, ATTN),
    sliding_window=4096,
    logit_softcap=30.0,
    attn_softcap=50.0,
    rope_theta=10000.0,
    act="gelu",
    tie_embeddings=True,
    source="arXiv:2408.00118 (Gemma 2)",
)
