"""HuBERT X-Large [arXiv:2106.07447] — encoder-only audio transformer.

The conv/mel front end is a stub: the model takes precomputed frame
embeddings (B, S, d).  Training objective is masked prediction over the
504-entry codebook.  Head dim 80, bidirectional attention.
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    arch_type="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    block_pattern=(ATTN,),
    causal=False,              # encoder-only: no decode
    rope_theta=0.0,            # conv positional encoding lives in the stub
    act="gelu",
    modality_frontend="audio",
    source="arXiv:2106.07447 (HuBERT)",
)
