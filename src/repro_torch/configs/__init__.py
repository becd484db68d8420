"""Config registry of the port: the architectures its model path serves
(and jamba's published config, whose MoE layers are not ported yet)."""
from repro_torch.configs.base import (BlockSpec, ModelConfig, ShapeConfig,
                                      reduced)
from repro_torch.configs.jamba_1_5_large_398b import CONFIG as JAMBA
from repro_torch.configs.jamba_1_5_large_398b import \
    DENSE_FFN as JAMBA_DENSE_FFN
from repro_torch.configs.yi_6b import CONFIG as YI_6B

REGISTRY = {c.name: c for c in (YI_6B, JAMBA, JAMBA_DENSE_FFN)}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


__all__ = ["REGISTRY", "get_config", "reduced", "BlockSpec", "ModelConfig",
           "ShapeConfig"]
