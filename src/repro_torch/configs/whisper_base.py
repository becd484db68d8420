"""Whisper-base  [arXiv:2212.04356].

Encoder-decoder: 6 encoder + 6 decoder layers, d_model=512 8H (kv=8)
d_ff=2048 vocab=51865.  The conv/mel frontend is a stub: the model takes
precomputed frame embeddings of shape (batch, frames, d_model).  The
port's copy of the JAX package's ``configs/whisper_base.py``.
"""
from repro_torch.configs.base import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,                  # decoder layers
    encoder_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51_865,
    block_pattern=(BlockSpec("attn", "dense"),),
    mlp_activation="gelu",
    gated_mlp=False,
    norm_kind="layernorm",
    frontend="audio",
    rope_theta=0.0,               # whisper uses learned/sinusoidal positions
)
