"""IBM Granite-3.0-1B-A400M-base  [hf:ibm-granite/granite-3.0-1b-a400m-base].

24L d_model=1024 16H (GQA kv=8) vocab=49155, MoE: 32 experts top-8 with
expert d_ff=512.
"""
from repro_torch.configs.base import BlockSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49_155,
    block_pattern=(BlockSpec("attn", "moe"),),
    moe=MoEConfig(
        num_experts=32,
        experts_per_token=8,
        expert_d_ff=512,
    ),
    rope_theta=10_000.0,
    mlp_activation="silu",
    norm_kind="rmsnorm",
    tie_embeddings=True,
)
