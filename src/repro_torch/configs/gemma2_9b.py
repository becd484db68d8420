"""Gemma2-9B  [arXiv:2408.00118].

42L d_model=3584 16H (GQA kv=8, head_dim=256) d_ff=14336 vocab=256000.
Alternating local (sliding-window 4096) / global attention, attention and
final logit soft-capping, pre+post block rmsnorm, GeGLU.
"""
from repro_torch.configs.base import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14_336,
    vocab_size=256_000,
    block_pattern=(
        BlockSpec("attn_local", "dense"),
        BlockSpec("attn_global", "dense"),
    ),
    window_size=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    rope_theta=10_000.0,
    mlp_activation="gelu",
    gated_mlp=True,
    norm_kind="rmsnorm",
    post_block_norm=True,
    tie_embeddings=True,
)
