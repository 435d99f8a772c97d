"""Paper-faithful DLRM configs with Criteo table cardinalities.

The port's own copy of ``repro.models.dlrm.DLRMConfig`` and of
``repro.configs.dlrm``: the same fields, cardinalities and ``scaled()``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class DLRMConfig:
    name: str
    num_dense: int                       # continuous features (13 for Criteo)
    table_sizes: Tuple[int, ...]         # rows per sparse table (26 tables)
    emb_dim: int                         # embedding vector dim
    bottom_mlp: Tuple[int, ...]          # hidden sizes incl. output (= emb_dim)
    top_mlp: Tuple[int, ...]             # hidden sizes, final = 1
    multi_hot: int = 1                   # lookups per table per sample
    source: str = ""

    @property
    def num_sparse(self) -> int:
        return len(self.table_sizes)

    @property
    def interaction_dim(self) -> int:
        f = self.num_sparse + 1
        return f * (f - 1) // 2 + self.emb_dim

    def total_emb_rows(self) -> int:
        return sum(self.table_sizes)


# Criteo Kaggle (Display Advertising Challenge) categorical cardinalities.
CRITEO_KAGGLE_TABLE_SIZES = (
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18, 15,
    286181, 105, 142572,
)

# Criteo Terabyte cardinalities (MLPerf reference, day-0..23, capped at 40M).
CRITEO_TERABYTE_TABLE_SIZES = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771, 25641295,
    39664984, 585935, 12972, 108, 36,
)

# Paper §5.1 configurations (MLPerf DLRM reference hyperparameters).
DLRM_KAGGLE = DLRMConfig(
    name="dlrm-kaggle",
    num_dense=13,
    table_sizes=CRITEO_KAGGLE_TABLE_SIZES,
    emb_dim=16,            # 64-byte fp32 vectors
    bottom_mlp=(512, 256, 64, 16),
    top_mlp=(512, 256, 1),
    source="MLPerf DLRM reference / arXiv:1906.00091, Kaggle hyperparams",
)

DLRM_TERABYTE = DLRMConfig(
    name="dlrm-terabyte",
    num_dense=13,
    table_sizes=CRITEO_TERABYTE_TABLE_SIZES,
    emb_dim=64,            # 256-byte fp32 vectors
    bottom_mlp=(512, 256, 64),
    top_mlp=(512, 512, 256, 1),
    source="MLPerf DLRM reference / arXiv:1906.00091, Terabyte hyperparams",
)


def scaled(cfg, max_rows: int = 100_000):
    """Shrink table cardinalities (keeping relative skew) for emulation."""
    top = max(cfg.table_sizes)
    sizes = tuple(max(4, min(n, int(max_rows * n / top)) if n > 100 else n)
                  for n in cfg.table_sizes)
    return dataclasses.replace(cfg, table_sizes=sizes,
                               name=cfg.name + f"-scaled{max_rows}")
