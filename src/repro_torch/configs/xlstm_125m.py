"""xLSTM-125M  [arXiv:2405.04517].

12L d_model=768 4H (kv=4) d_ff=0 (no external FFN: the blocks carry their
own up-projections) vocab=50304.  sLSTM + mLSTM blocks, the paper's
xLSTM[7:1]-style mix approximated at period 4 (3 mLSTM : 1 sLSTM), as the
JAX package holds it field for field.
"""
from repro_torch.configs.base import BlockSpec, ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    block_pattern=(
        BlockSpec("mlstm", "none"),
        BlockSpec("mlstm", "none"),
        BlockSpec("mlstm", "none"),
        BlockSpec("slstm", "none"),
    ),
    xlstm=XLSTMConfig(mlstm_proj_factor=2.0, slstm_proj_factor=4.0 / 3.0),
    norm_kind="layernorm",
    tie_embeddings=True,
    subquadratic=True,
)
