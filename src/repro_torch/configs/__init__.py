"""Config registry of the port: the architectures its model path serves."""
from repro_torch.configs.base import (BlockSpec, ModelConfig, ShapeConfig,
                                      reduced)
from repro_torch.configs.yi_6b import CONFIG as YI_6B

REGISTRY = {c.name: c for c in (YI_6B,)}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


__all__ = ["REGISTRY", "get_config", "reduced", "BlockSpec", "ModelConfig",
           "ShapeConfig"]
