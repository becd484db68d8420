"""Config registry of the port: every architecture of the JAX package's
registry (jamba's published config, MoE layers included, beside the
dense-FFN and 8-expert cuts that one card holds), and the paper's own
DeiT family (``PAPER_MODELS``)."""
from repro_torch.configs.base import (BlockSpec, ModelConfig, MoEConfig,
                                      ShapeConfig, reduced)
from repro_torch.configs.deit import (DEIT_160, DEIT_256, DEIT_T, LV_VIT_T,
                                      VIT_SEQ, vit_shape)
from repro_torch.configs.gemma2_9b import CONFIG as GEMMA2_9B
from repro_torch.configs.granite_moe_1b_a400m import CONFIG as GRANITE_MOE
from repro_torch.configs.jamba_1_5_large_398b import CONFIG as JAMBA
from repro_torch.configs.jamba_1_5_large_398b import \
    DENSE_FFN as JAMBA_DENSE_FFN
from repro_torch.configs.jamba_1_5_large_398b import MOE_8E as JAMBA_MOE_8E
from repro_torch.configs.nemotron_4_15b import CONFIG as NEMOTRON_15B
from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as QWEN2_MOE
from repro_torch.configs.qwen2_vl_72b import CONFIG as QWEN2_VL_72B
from repro_torch.configs.whisper_base import CONFIG as WHISPER_BASE
from repro_torch.configs.xlstm_125m import CONFIG as XLSTM_125M
from repro_torch.configs.yi_34b import CONFIG as YI_34B
from repro_torch.configs.yi_6b import CONFIG as YI_6B

# Paper models (FPGA'24 Table 3).
PAPER_MODELS = {c.name: c for c in (DEIT_T, DEIT_160, DEIT_256, LV_VIT_T)}

REGISTRY = {**{c.name: c for c in (YI_6B, JAMBA, JAMBA_DENSE_FFN,
                                   JAMBA_MOE_8E, QWEN2_MOE, GRANITE_MOE,
                                   NEMOTRON_15B, YI_34B, GEMMA2_9B,
                                   WHISPER_BASE, XLSTM_125M, QWEN2_VL_72B)},
            **PAPER_MODELS}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


__all__ = ["REGISTRY", "PAPER_MODELS", "get_config", "reduced", "vit_shape",
           "VIT_SEQ", "BlockSpec", "ModelConfig", "MoEConfig", "ShapeConfig"]
