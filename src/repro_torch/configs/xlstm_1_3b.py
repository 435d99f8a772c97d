"""xLSTM-1.3B [arXiv:2405.04517] — mLSTM/sLSTM blocks at ratio 7:1."""
from repro_torch.configs.base import MLSTM, SLSTM, ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    arch_type="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    head_dim=512,
    d_ff=0,                    # blocks carry their own projections
    vocab_size=50304,
    block_pattern=(MLSTM,) * 7 + (SLSTM,),
    rope_theta=0.0,
    source="arXiv:2405.04517 (xLSTM)",
)
