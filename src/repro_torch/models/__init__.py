"""The language models that the serving engine runs: the SSM
(falcon-mamba, Mamba-1) and hybrid (zamba2, Mamba-2 + shared attention)
families, ported from ``repro.models``."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import MODEL_FAMILIES, get_model

__all__ = ["ModelConfig", "get_model", "MODEL_FAMILIES"]
