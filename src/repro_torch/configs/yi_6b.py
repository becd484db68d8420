"""Yi-6B  [arXiv:2403.04652] — llama-arch GQA dense.

32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
"""
from repro_torch.configs.base import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    d_ff=11_008,
    vocab_size=64_000,
    block_pattern=(BlockSpec("attn", "dense"),),
    rope_theta=5_000_000.0,
    mlp_activation="silu",
    norm_kind="rmsnorm",
)
