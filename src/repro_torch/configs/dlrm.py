"""DLRM — the paper's CTR benchmark (Table 5), Criteo-Terabyte scale.

Port of ``repro/configs/dlrm.py``.  DLRM [arXiv:1906.00091 / Naumov &
Mudigere 2020]: sparse embedding tables + bottom MLP over dense features +
dot-product feature interaction + top MLP.  The paper trains it with SGD vs
VR-SGD at 32k..512k batch.  The model is models/dlrm.py; train/driver.py
steps it.  Not in the transformer registry (configs/__init__.py): DLRM is no
``ModelConfig``.
"""
import dataclasses
from typing import Tuple

from repro_torch.configs.base import OptimizerConfig


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm"
    n_dense_features: int = 13
    n_sparse_features: int = 26
    embedding_dim: int = 128
    # Criteo-TB-scale table sizes are O(10M); hashed down here per common practice
    table_size: int = 1 << 20
    bottom_mlp: Tuple[int, ...] = (512, 256, 128)
    top_mlp: Tuple[int, ...] = (1024, 1024, 512, 256, 1)
    citation: str = "Naumov & Mudigere 2020 / paper Table 5"


def config() -> DLRMConfig:
    return DLRMConfig()


def smoke() -> DLRMConfig:
    return DLRMConfig(
        name="dlrm-smoke",
        embedding_dim=16,
        table_size=64,
        n_sparse_features=4,
        bottom_mlp=(32, 16),
        top_mlp=(64, 32, 1),
    )


def optimizer(batch_size: int = 32768) -> OptimizerConfig:
    # paper Appendix Table 11: SGD/VR-SGD, poly decay, warm-up, k=8, gamma=0.1
    return OptimizerConfig(
        name="vr_sgd", lr=2 ** 3.5, schedule="poly", gamma=0.1, k=8, warmup_steps=100
    )
