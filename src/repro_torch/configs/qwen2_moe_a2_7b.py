"""Qwen1.5/2-MoE-A2.7B  [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L d_model=2048 16H (kv=16) vocab=151936, MoE: 60 routed experts top-4 with
expert d_ff=1408, plus 4 shared experts (modeled as one fused shared expert of
4*1408=5632, matching the HF ``shared_expert_intermediate_size``).
"""
from repro_torch.configs.base import BlockSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5632,                     # dense-equivalent ff (shared path)
    vocab_size=151_936,
    block_pattern=(BlockSpec("attn", "moe"),),
    moe=MoEConfig(
        num_experts=60,
        experts_per_token=4,
        expert_d_ff=1408,
        num_shared_experts=4,
        shared_expert_d_ff=5632,
    ),
    rope_theta=1_000_000.0,
    mlp_activation="silu",
    norm_kind="rmsnorm",
)
