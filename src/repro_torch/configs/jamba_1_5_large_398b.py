"""Jamba-1.5-Large (398B total / 94B active class)  [arXiv:2403.19887].

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536.
Mamba:attention 1:7 interleave (one attention layer per 8-layer period,
position 3 inside the period, as in the released model), MoE 16 experts
top-2 on every other layer.

``CONFIG`` is the published model, field for field as the JAX package
holds it, MoE layers included: the port builds and runs it (tested at
``reduced`` width against the JAX package).  At published width one MoE
layer's 16 experts of d_ff 24,576 are 19.3 GB in bf16, more than one
H100 holds beside the rest of a period, so the card serves two cuts of
it.  Both keep the widths (d_model 8192, 64 heads, 8 KV heads, head_dim
128, vocab 65536, d_ff 24576, mamba d_state 16, d_conv 4, expand 2:
d_inner 16384, dt_rank 512), the rope-free attention, RMSNorm, gated
SiLU and untied head, and the period (attention at position 3, mamba
elsewhere):

  * ``DENSE_FFN``, ``jamba-1.5-large-398b-dense-ffn``: the four MoE FFN
    positions of each period (1, 3, 5, 7) run as the dense gated FFN of
    the same width, 24,576 (the expert width); per token they do half
    the FFN work of top-2 routing;
  * ``MOE_8E``, ``jamba-1.5-large-398b-8e``: the published MoE period
    (MoE on positions 1, 3, 5, 7, top-2, expert d_ff 24,576, capacity
    factor 1.25) with **8 of the 16 experts** in each MoE layer.  In
    bf16 a mamba layer is ~0.84 GB, the attention layer 0.30, a dense
    FFN or one expert 1.21, embed + head 2.15: one 8-layer period is
    about 13.2 + 4.83·E GB, 90.5 GB at E=16 (does not fit), 71 GB at
    E=12 (no room left for the prefill's f32 expert hidden state and
    the workspace), 51.8 GB at E=8.

Runs on the card also cut the depth (``--layers``, a multiple of the
8-layer period): the dense-FFN cut serves 16 layers (2 periods, ~17 B
parameters, ~34 GB in bf16) and runs 8 in f32 for parity; the 8-expert
cut serves one period in bf16, and its f32 parity runs one period with
2 experts (~45.6 GB).
"""
import dataclasses

from repro_torch.configs.base import BlockSpec, ModelConfig, MoEConfig, \
    SSMConfig

_PERIOD = []
for i in range(8):
    mixer = "attn" if i == 3 else "mamba"
    ffn = "moe" if i % 2 == 1 else "dense"
    _PERIOD.append(BlockSpec(mixer, ffn))

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24_576,
    vocab_size=65_536,
    block_pattern=tuple(_PERIOD),
    moe=MoEConfig(
        num_experts=16,
        experts_per_token=2,
        expert_d_ff=24_576,
    ),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    rope_theta=0.0,               # jamba attention layers use no RoPE
    mlp_activation="silu",
    norm_kind="rmsnorm",
    subquadratic=True,            # mamba-dominated: long_500k applies
)

DENSE_FFN = dataclasses.replace(
    CONFIG,
    name="jamba-1.5-large-398b-dense-ffn",
    block_pattern=tuple(BlockSpec(b.mixer, "dense") for b in _PERIOD),
    moe=None,
)

MOE_8E = dataclasses.replace(
    CONFIG,
    name="jamba-1.5-large-398b-8e",
    moe=dataclasses.replace(CONFIG.moe, num_experts=8),
)
