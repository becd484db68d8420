"""Qwen2-VL-72B  [arXiv:2409.12191].

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.  M-RoPE with
(temporal, height, width) sections of 16, 24 and 24 frequencies (head_dim
128 / 2).  The dynamic-resolution vision tower is a stub, as in the JAX
package: the caller hands in the merged text + patch embeddings
(``batch["embeds"]``) and their (3, B, S) positions.
"""
from repro_torch.configs.base import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29_568,
    vocab_size=152_064,
    block_pattern=(BlockSpec("attn", "dense"),),
    mrope_sections=(16, 24, 24),   # sums to head_dim/2 = 64
    rope_theta=1_000_000.0,
    mlp_activation="silu",
    norm_kind="rmsnorm",
    frontend="vision",
)
