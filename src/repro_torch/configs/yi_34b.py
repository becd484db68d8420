"""Yi-34B  [arXiv:2403.04652] — llama-arch GQA dense.

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
"""
from repro_torch.configs.base import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20_480,
    vocab_size=64_000,
    block_pattern=(BlockSpec("attn", "dense"),),
    rope_theta=5_000_000.0,
    mlp_activation="silu",
    norm_kind="rmsnorm",
)
