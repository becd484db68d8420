"""Base configuration dataclasses for the PyTorch port.

The port's own copy of the JAX package's ``configs/base.py`` (pure data,
kept field-for-field identical so a config built on either side describes
the same model).  Models are built from them by
``repro_torch.models.model.build_model``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Block-kind vocabulary
# ---------------------------------------------------------------------------
# A layer ("block") is a (mixer, ffn) pair.  ``block_pattern`` holds one
# period of the repeating layer pattern; the full stack is
# ``num_layers // len(block_pattern)`` repetitions of it (scanned).
MIXER_KINDS = (
    "attn",          # full (causal for LM) attention
    "attn_local",    # sliding-window attention
    "attn_global",   # full attention in an alternating local/global stack
    "mamba",         # Mamba-1 selective SSM mixer
    "mlstm",         # xLSTM matrix-memory block
    "slstm",         # xLSTM scalar-memory block
)
FFN_KINDS = ("dense", "moe", "none")


@dataclass(frozen=True)
class BlockSpec:
    """One layer position inside the repeating pattern."""
    mixer: str = "attn"
    ffn: str = "dense"

    def __post_init__(self):
        assert self.mixer in MIXER_KINDS, self.mixer
        assert self.ffn in FFN_KINDS, self.ffn


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    experts_per_token: int = 2
    # Routed-expert FFN hidden dim (may differ from dense d_ff).
    expert_d_ff: int = 0
    num_shared_experts: int = 0
    shared_expert_d_ff: int = 0
    # Capacity factor for dropping-based dispatch (GShard-style).
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-1 mixer hyper-params (used when a block's mixer == 'mamba')."""
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block hyper-params (mixer in {'mlstm','slstm'})."""
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0
    conv_kernel: int = 4


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # Repeating layer pattern (length divides num_layers).
    block_pattern: Tuple[BlockSpec, ...] = (BlockSpec(),)

    # Attention variants.
    window_size: int = 4096          # for attn_local
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = ()   # e.g. (16,24,24) for qwen2-vl
    attn_logit_softcap: float = 0.0        # 0 -> disabled
    final_logit_softcap: float = 0.0
    qk_norm: bool = False

    # FFN / norms.
    mlp_activation: str = "silu"     # silu | gelu | relu2
    gated_mlp: bool = True
    norm_kind: str = "rmsnorm"       # rmsnorm | layernorm
    post_block_norm: bool = False    # gemma2-style pre+post norms
    tie_embeddings: bool = False

    moe: Optional[MoEConfig] = None
    ssm: SSMConfig = SSMConfig()
    xlstm: XLSTMConfig = XLSTMConfig()

    # Encoder-decoder (whisper): encoder layer count; decoder = num_layers.
    encoder_layers: int = 0
    # Modality frontend stub: inputs are precomputed embeddings of this dim
    # rather than token ids ('' = token ids).
    frontend: str = ""               # '' | 'audio' | 'vision'

    # Numerics.
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"

    # Long-context capability: True if per-token state is O(1)/sub-quadratic
    # (SSM / hybrid) so long_500k applies.
    subquadratic: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        assert self.num_layers % len(self.block_pattern) == 0, (
            f"{self.name}: num_layers={self.num_layers} not divisible by "
            f"pattern length {len(self.block_pattern)}")
        assert self.num_heads % max(self.num_kv_heads, 1) == 0

    # ----- derived -----
    @property
    def num_groups(self) -> int:
        """Number of scan iterations (pattern repetitions)."""
        return self.num_layers // len(self.block_pattern)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def pattern_mixers(self) -> Tuple[str, ...]:
        return tuple(b.mixer for b in self.block_pattern)

    def has_attention(self) -> bool:
        return any(b.mixer.startswith("attn") for b in self.block_pattern)

    def is_pure_full_attention(self) -> bool:
        """True if every mixer is (possibly windowed-alternating) softmax
        attention — i.e. no O(1)-state path exists for very long context."""
        return all(b.mixer.startswith("attn") for b in self.block_pattern)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


# The four assigned LM shapes (identical across archs).
TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}


def shapes_for(cfg: ModelConfig) -> Tuple[ShapeConfig, ...]:
    """Shapes applicable to ``cfg`` (long_500k only for sub-quadratic archs;
    skips are recorded, not silently dropped — see dryrun.py)."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.subquadratic:
        out.append(LONG_500K)
    return tuple(out)


def reduced(cfg: ModelConfig, *, layers: int = 0, d_model: int = 64,
            vocab: int = 256) -> ModelConfig:
    """A smoke-test-sized config of the same family: keeps one full pattern
    period (so every block kind is exercised) but tiny dims."""
    period = len(cfg.block_pattern)
    n_layers = layers or period * min(2, cfg.num_groups)
    heads = min(cfg.num_heads, 4)
    kv = max(1, min(cfg.num_kv_heads, 2))
    while heads % kv:
        kv -= 1
    head_dim = 16
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(
            cfg.moe, num_experts=4,
            experts_per_token=min(cfg.moe.experts_per_token, 2),
            expert_d_ff=32,
            num_shared_experts=min(cfg.moe.num_shared_experts, 1),
            shared_expert_d_ff=64)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=n_layers,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=head_dim,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=vocab,
        window_size=min(cfg.window_size, 16),
        encoder_layers=min(cfg.encoder_layers, 2),
        moe=moe,
        ssm=dataclasses.replace(cfg.ssm, d_state=8, d_conv=4, expand=2),
        mrope_sections=(2, 3, 3) if cfg.mrope_sections else (),  # sums hd/2
        dtype="float32",
        param_dtype="float32",
    )


SMOKE_SHAPE = ShapeConfig("smoke", 32, 2, "train")
SMOKE_DECODE = ShapeConfig("smoke_decode", 64, 2, "decode")
