"""Nemotron-4-15B  [arXiv:2402.16819].

32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000, squared-ReLU MLP
(non-gated), layernorm.
"""
from repro_torch.configs.base import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=24_576,
    vocab_size=256_000,
    block_pattern=(BlockSpec("attn", "dense"),),
    rope_theta=10_000.0,
    mlp_activation="relu2",
    gated_mlp=False,
    norm_kind="layernorm",
)
