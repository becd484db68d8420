"""The paper's own models (Table 3): DeiT-T, DeiT-160, DeiT-256, LV-ViT-T.

Encoder-only vision transformers for image classification; 196 patches + 1
cls token = 197 sequence positions at 224x224/16.  The port's copy of the
JAX package's ``configs/deit.py`` (field for field).  The patch-embedding
conv is a stub: ``Model.forward`` takes patch embeddings (B, 196, D).
Head dims: DeiT-T 64, DeiT-160 40, DeiT-256 64, LV-ViT-T 60.
"""
from repro_torch.configs.base import BlockSpec, ModelConfig, ShapeConfig


def _vit(name, heads, dim, depth, d_ff=None):
    return ModelConfig(
        name=name,
        family="vision",
        num_layers=depth,
        d_model=dim,
        num_heads=heads,
        num_kv_heads=heads,
        d_ff=d_ff if d_ff is not None else 4 * dim,
        vocab_size=1000,              # classifier head
        block_pattern=(BlockSpec("attn", "dense"),),
        mlp_activation="gelu",
        gated_mlp=False,
        norm_kind="layernorm",
        rope_theta=0.0,               # learned positions
        frontend="vision",
    )


DEIT_T = _vit("deit-t", heads=3, dim=192, depth=12)
DEIT_160 = _vit("deit-160", heads=4, dim=160, depth=12)
DEIT_256 = _vit("deit-256", heads=4, dim=256, depth=12)
LV_VIT_T = _vit("lv-vit-t", heads=4, dim=240, depth=12)

VIT_SEQ = 197  # 196 patches + cls


def vit_shape(batch: int) -> ShapeConfig:
    return ShapeConfig(f"vit_b{batch}", VIT_SEQ, batch, "prefill")
