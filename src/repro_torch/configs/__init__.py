"""Config registry of the port: the architectures its model path serves,
jamba's published config (MoE layers included) beside the dense-FFN cut
that one card holds."""
from repro_torch.configs.base import (BlockSpec, ModelConfig, MoEConfig,
                                      ShapeConfig, reduced)
from repro_torch.configs.gemma2_9b import CONFIG as GEMMA2_9B
from repro_torch.configs.granite_moe_1b_a400m import CONFIG as GRANITE_MOE
from repro_torch.configs.jamba_1_5_large_398b import CONFIG as JAMBA
from repro_torch.configs.jamba_1_5_large_398b import \
    DENSE_FFN as JAMBA_DENSE_FFN
from repro_torch.configs.nemotron_4_15b import CONFIG as NEMOTRON_15B
from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as QWEN2_MOE
from repro_torch.configs.yi_34b import CONFIG as YI_34B
from repro_torch.configs.yi_6b import CONFIG as YI_6B

REGISTRY = {c.name: c for c in (YI_6B, JAMBA, JAMBA_DENSE_FFN, QWEN2_MOE,
                                GRANITE_MOE, NEMOTRON_15B, YI_34B,
                                GEMMA2_9B)}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


__all__ = ["REGISTRY", "get_config", "reduced", "BlockSpec", "ModelConfig",
           "MoEConfig", "ShapeConfig"]
