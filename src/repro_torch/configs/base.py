"""Model / run configuration dataclasses shared by every architecture.

The port's own copy of ``repro.configs.base`` (which the port may not
import): the same fields, layer kinds, ``reduced()`` and
``param_counts()``.  A ``ModelConfig`` fully describes one architecture;
``reduced()`` gives the CPU-smoke variant (2 layers, d_model<=512, <=4
experts).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


# Layer kinds used in ``block_pattern``.  A pattern is tiled over the depth;
# homogeneous models use a single-entry pattern.
ATTN = "attn"            # global self-attention
LOCAL_ATTN = "local"     # sliding-window self-attention
RECURRENT = "rglru"      # RG-LRU recurrent block (RecurrentGemma)
MLSTM = "mlstm"          # xLSTM mLSTM block
SLSTM = "slstm"          # xLSTM sLSTM block
MOE = "moe"              # attention + MoE FFN layer


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden dim
    num_shared_experts: int = 0
    d_shared: int = 0             # hidden dim of the fused shared expert(s)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads
    block_pattern: Tuple[str, ...] = (ATTN,)
    moe: Optional[MoEConfig] = None
    # attention details
    rope_theta: float = 10000.0
    mrope: bool = False           # Qwen2-VL multimodal RoPE
    qkv_bias: bool = False
    sliding_window: int = 0       # window for LOCAL_ATTN layers
    logit_softcap: float = 0.0    # gemma2 final-logit softcap
    attn_softcap: float = 0.0     # gemma2 attention-logit softcap
    # recurrent details
    rglru_width: int = 0          # RG-LRU recurrence width (= d_model expansion)
    conv1d_width: int = 4
    # structural flags
    causal: bool = True           # False -> encoder-only (hubert)
    tie_embeddings: bool = False
    modality_frontend: Optional[str] = None  # "audio" | "vision" (stub embeds)
    norm_eps: float = 1e-6
    act: str = "silu"             # mlp activation: silu (swiglu) | gelu
    source: str = ""              # citation for the config
    # dtype of params/activations in the production lowering
    dtype: str = "bfloat16"
    kv_cache_dtype: str = "bf16"   # "int8" -> quantized decode cache

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer kind list, pattern tiled (possibly truncated) to depth."""
        reps = -(-self.num_layers // len(self.block_pattern))
        return tuple((self.block_pattern * reps)[: self.num_layers])

    @property
    def supports_decode(self) -> bool:
        return self.causal

    @property
    def subquadratic(self) -> bool:
        """True if no layer needs an unbounded-length KV cache."""
        return all(k != ATTN and k != MOE for k in self.layer_kinds) or (
            self.sliding_window > 0 and ATTN not in self.layer_kinds
        )

    def reduced(self) -> "ModelConfig":
        """CPU smoke-test variant: 2 layers, d_model<=512, <=4 experts."""
        d = min(self.d_model, 256)
        heads = max(1, min(self.num_heads, 4))
        kv = max(1, min(self.num_kv_heads, heads))
        while heads % kv:
            kv -= 1
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe,
                num_experts=min(self.moe.num_experts, 4),
                top_k=min(self.moe.top_k, 2),
                d_expert=min(self.moe.d_expert, 128),
                num_shared_experts=min(self.moe.num_shared_experts, 1),
                d_shared=min(self.moe.d_shared, 128),
                capacity_factor=4.0,  # avoid drops in tiny smoke tests
            )
        pat = self.block_pattern
        if len(pat) > 2:  # keep heterogeneity but fit in 2 layers
            pat = (pat[0], pat[-1])
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=2,
            d_model=d,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=d // heads,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            rglru_width=min(self.rglru_width, d) if self.rglru_width else 0,
            block_pattern=pat,
            moe=moe,
            dtype="float32",
        )

    # ---- analytic parameter / FLOP accounting (for rooflines) -------------
    def param_counts(self) -> dict:
        """Analytic parameter counts by group (embedding / dense / expert)."""
        d, hd = self.d_model, self.head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = {}
        for kind in set(self.layer_kinds):
            p = 2 * d  # two rmsnorm scales
            if kind in (ATTN, LOCAL_ATTN, MOE):
                p += d * hd * (nq + 2 * nkv) + nq * hd * d
                if self.qkv_bias:
                    p += hd * (nq + 2 * nkv)
            if kind == RECURRENT:
                w = self.rglru_width or d
                p += 2 * d * w + w * d + 2 * w * self.conv1d_width + 4 * w
            if kind in (MLSTM, SLSTM):
                w = d
                p += 4 * d * w + w * d + 6 * w
            if kind == MOE:
                m = self.moe
                p += d * m.num_experts  # router
                p += m.num_experts * 3 * d * m.d_expert
                if m.num_shared_experts:
                    p += 3 * d * m.d_shared
            elif kind in (ATTN, LOCAL_ATTN, RECURRENT, MLSTM, SLSTM) and self.d_ff:
                p += 3 * d * self.d_ff if self.act == "silu" else 2 * d * self.d_ff
            per_layer[kind] = p
        dense = sum(per_layer[k] for k in self.layer_kinds)
        return {"embedding": emb, "blocks": dense, "total": emb + dense}

    def active_param_count(self) -> int:
        """Params touched per token (MoE counts only top-k + shared experts)."""
        total = self.param_counts()["total"]
        if self.moe is None:
            return total
        m = self.moe
        n_moe = sum(1 for k in self.layer_kinds if k == MOE)
        inactive = n_moe * (m.num_experts - m.top_k) * 3 * self.d_model * m.d_expert
        return total - inactive


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
