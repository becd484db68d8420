"""Layer-graph IR for SSR scheduling.

The paper's Layer→Acc scheduler operates on the application graph (Fig. 4/5).
We build that graph from (ModelConfig × ShapeConfig): one node per
transformer block (plus embed/head), each annotated with

  * ``mm``          — list of MatmulShape (MXU work; the HMM part),
  * ``vpu_flops``   — nonlinear/elementwise work (the HCE part),
  * ``act_in/out``  — activation bytes crossing the node boundary
                      (the inter-acc communication the paper co-designs),
  * ``weight_bytes``— resident weights (HMM-type0 "pinning" budget),
  * ``state_bytes`` — KV-cache / recurrent state traffic per invocation,
  * ``deps``        — graph dependencies.

FLOP counts are *model FLOPs* for the whole (global_batch × seq) workload;
the cost model divides by the accelerator allocation.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Tuple

from repro_torch.configs.base import BlockSpec, ModelConfig, ShapeConfig

# decoder length = seq_len // 4 for audio shapes (the JAX package's
# ``models/model.py`` constant, which the port's model facade has no use
# for: its callers give the decoder tokens)
AUDIO_DECODER_RATIO = 4

BYTES = 2  # bf16


@dataclass(frozen=True)
class MatmulShape:
    m: int
    k: int
    n: int
    count: int = 1          # batched-matmul count (e.g. heads)
    tp_dim: str = "n"       # which dim tensor-parallelism splits: n|k|count
    dp_dim: str = "m"       # data parallelism always splits m (tokens)

    @property
    def flops(self) -> float:
        return 2.0 * self.m * self.k * self.n * self.count


@dataclass
class Node:
    idx: int
    name: str
    kind: str                       # embed|block|head
    mixer: str = ""                 # attn|mamba|... for blocks
    role: str = ""                  # op-granularity role (qkv|bmm_qk|...)
    mm: List[MatmulShape] = field(default_factory=list)
    vpu_flops: float = 0.0
    act_in: float = 0.0             # bytes
    act_out: float = 0.0
    weight_bytes: float = 0.0
    state_bytes: float = 0.0        # KV/recurrent state read+written
    deps: Tuple[int, ...] = ()

    @property
    def mm_flops(self) -> float:
        return sum(s.flops for s in self.mm)


@dataclass
class Graph:
    cfg: ModelConfig
    shape: ShapeConfig
    nodes: List[Node]
    train: bool = False

    @property
    def total_mm_flops(self) -> float:
        mult = 3.0 if self.train else 1.0        # fwd + bwd(2x)
        return mult * sum(n.mm_flops for n in self.nodes)

    @property
    def total_vpu_flops(self) -> float:
        mult = 2.0 if self.train else 1.0
        return mult * sum(n.vpu_flops for n in self.nodes)

    @property
    def total_weight_bytes(self) -> float:
        return sum(n.weight_bytes for n in self.nodes)


# ---------------------------------------------------------------------------
# per-block op accounting
# ---------------------------------------------------------------------------

def _attn_block(cfg: ModelConfig, blk: BlockSpec, B, S, kv_len, decode):
    """MatmulShapes + vpu flops for one attention block."""
    d, H, Hk, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    tok = B * S
    mm = [
        MatmulShape(tok, d, H * hd, tp_dim="n"),          # wq
        MatmulShape(tok, d, Hk * hd, tp_dim="n"),         # wk
        MatmulShape(tok, d, Hk * hd, tp_dim="n"),         # wv
        MatmulShape(tok, H * hd, d, tp_dim="k"),          # wo
    ]
    eff_kv = kv_len
    if blk.mixer == "attn_local":
        eff_kv = min(kv_len, cfg.window_size)
    causal_frac = 0.5 if (not decode and S == kv_len) else 1.0
    # scores + pv bmm (per query-head)
    mm.append(MatmulShape(S * causal_frac, hd, eff_kv, count=B * H,
                          tp_dim="count"))
    mm.append(MatmulShape(S * causal_frac, eff_kv, hd, count=B * H,
                          tp_dim="count"))
    vpu = 5.0 * B * H * S * eff_kv * causal_frac        # softmax
    vpu += 8.0 * tok * d                                 # norms + residual
    vpu += 6.0 * tok * H * hd                            # rope
    w = (2 * d * H * hd + 2 * d * Hk * hd) * BYTES
    state = 2 * B * eff_kv * Hk * hd * BYTES if decode else 0
    return mm, vpu, w, state


def _ffn(cfg: ModelConfig, blk: BlockSpec, B, S):
    d = cfg.d_model
    tok = B * S
    mm, vpu, w = [], 0.0, 0.0
    if blk.ffn == "dense":
        ff = cfg.d_ff
        n_in = 2 if cfg.gated_mlp else 1
        for _ in range(n_in):
            mm.append(MatmulShape(tok, d, ff, tp_dim="n"))
        mm.append(MatmulShape(tok, ff, d, tp_dim="k"))
        vpu += 4.0 * tok * ff
        w += (n_in + 1) * d * ff * BYTES
    elif blk.ffn == "moe":
        moe = cfg.moe
        e, k, ff = moe.num_experts, moe.experts_per_token, moe.expert_d_ff
        cf = moe.capacity_factor
        mm.append(MatmulShape(tok, d, e, tp_dim="n"))               # router
        routed_tok = int(tok * k * cf)
        per_exp = max(routed_tok // e, 1)
        for _ in range(2):
            mm.append(MatmulShape(per_exp, d, ff, count=e, tp_dim="n"))
        mm.append(MatmulShape(per_exp, ff, d, count=e, tp_dim="k"))
        vpu += 4.0 * routed_tok * ff + 10.0 * tok * e
        w += 3 * e * d * ff * BYTES
        if moe.num_shared_experts:
            sf = moe.shared_expert_d_ff
            mm.append(MatmulShape(tok, d, sf, tp_dim="n"))
            mm.append(MatmulShape(tok, d, sf, tp_dim="n"))
            mm.append(MatmulShape(tok, sf, d, tp_dim="k"))
            vpu += 4.0 * tok * sf
            w += 3 * d * sf * BYTES
    if blk.ffn != "none":
        vpu += 6.0 * tok * d                                        # norm+res
    return mm, vpu, w


def _mamba_block(cfg: ModelConfig, B, S):
    d = cfg.d_model
    di = cfg.ssm.expand * d
    n = cfg.ssm.d_state
    dtr = cfg.ssm.dt_rank or math.ceil(d / 16)
    tok = B * S
    mm = [
        MatmulShape(tok, d, 2 * di, tp_dim="n"),          # in_proj
        MatmulShape(tok, di, dtr + 2 * n, tp_dim="k"),    # x_proj
        MatmulShape(tok, dtr, di, tp_dim="n"),            # dt_proj
        MatmulShape(tok, di, d, tp_dim="k"),              # out_proj
    ]
    vpu = tok * di * (2 * cfg.ssm.d_conv + 10 * n + 10)   # conv+scan+gates
    w = (2 * d * di + di * (dtr + 2 * n) + dtr * di + di * d) * BYTES
    state = B * di * (n + cfg.ssm.d_conv) * 4             # fp32 state
    return mm, vpu, w, state


def _mlstm_block(cfg: ModelConfig, B, S, decode):
    d = cfg.d_model
    di = int(cfg.xlstm.mlstm_proj_factor * d)
    H = cfg.num_heads
    hd = di // H
    tok = B * S
    mm = [
        MatmulShape(tok, d, 2 * di, tp_dim="n"),
        MatmulShape(tok, di, di, tp_dim="n"),
        MatmulShape(tok, di, di, tp_dim="n"),
        MatmulShape(tok, di, di, tp_dim="n"),
        MatmulShape(tok, di, d, tp_dim="k"),
    ]
    # recurrence: rank-1 state updates, O(S * hd^2) per head — VPU/MXU mix;
    # count as MXU work in chunked form.
    mm.append(MatmulShape(S, hd, hd, count=2 * B * H, tp_dim="count"))
    vpu = tok * (10 * di + 8 * d)
    w = (2 * d * di + 3 * di * di + di * d) * BYTES
    state = B * H * hd * hd * 4 if decode else 0
    return mm, vpu, w, state


def _slstm_block(cfg: ModelConfig, B, S):
    d = cfg.d_model
    H = cfg.num_heads
    hd = d // H
    ff = int(cfg.xlstm.slstm_proj_factor * d)
    tok = B * S
    mm = [
        MatmulShape(tok, d, 4 * d, tp_dim="n"),                   # w_x
        MatmulShape(tok, hd, 4 * hd, count=H, tp_dim="count"),    # recurrent
        MatmulShape(tok, d, 2 * ff, tp_dim="n"),
        MatmulShape(tok, ff, d, tp_dim="k"),
    ]
    vpu = tok * 30 * d
    w = (4 * d * d + H * hd * 4 * hd + 3 * d * ff) * BYTES
    return mm, vpu, w, 4 * B * d * 4


# ---------------------------------------------------------------------------
# graph construction
# ---------------------------------------------------------------------------

def _block_node(cfg, blk, idx, name, B, S, kv_len, decode, deps):
    if blk.mixer.startswith("attn"):
        mm, vpu, w, st = _attn_block(cfg, blk, B, S, kv_len, decode)
    elif blk.mixer == "mamba":
        mm, vpu, w, st = _mamba_block(cfg, B, S)
    elif blk.mixer == "mlstm":
        mm, vpu, w, st = _mlstm_block(cfg, B, S, decode)
    elif blk.mixer == "slstm":
        mm, vpu, w, st = _slstm_block(cfg, B, S)
    else:
        raise ValueError(blk.mixer)
    mm2, vpu2, w2 = _ffn(cfg, blk, B, S)
    act = B * S * cfg.d_model * BYTES
    return Node(idx=idx, name=name, kind="block", mixer=blk.mixer,
                mm=mm + mm2, vpu_flops=vpu + vpu2, act_in=act, act_out=act,
                weight_bytes=w + w2, state_bytes=st, deps=deps)


def build_op_graph(cfg: ModelConfig, shape: ShapeConfig) -> Graph:
    """Op-granularity graph (paper Fig. 4): every attention block becomes
    qkv / bmm_qk / bmm_pv / wo / ffn_in / ffn_out nodes so each op can own a
    specialized accelerator reused across layers (paper Fig. 9).  Non-attn
    mixers stay whole (they are single fused ops on the target)."""
    B = shape.global_batch
    decode = shape.is_decode
    S = 1 if decode else shape.seq_len
    kv_len = shape.seq_len
    train = shape.kind == "train"
    d, H, Hk, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    tok = B * S
    act = tok * d * BYTES

    nodes: List[Node] = []
    nodes.append(Node(0, "embed", "embed", role="embed", act_out=act,
                      weight_bytes=0 if cfg.family in ("vlm", "vision")
                      else cfg.vocab_size * d * BYTES,
                      vpu_flops=tok * d, deps=()))
    prev = 0
    for li in range(cfg.num_layers):
        blk = cfg.block_pattern[li % len(cfg.block_pattern)]
        if blk.mixer.startswith("attn"):
            eff_kv = min(kv_len, cfg.window_size) \
                if blk.mixer == "attn_local" else kv_len
            cf = 0.5 if (not decode and S == kv_len) else 1.0
            qkv = Node(len(nodes), f"L{li}.qkv", "block", "attn", role="qkv",
                       mm=[MatmulShape(tok, d, (H + 2 * Hk) * hd, tp_dim="n")],
                       vpu_flops=8.0 * tok * d + 6 * tok * H * hd,
                       act_in=act, act_out=(H + 2 * Hk) * hd * tok * BYTES,
                       weight_bytes=d * (H + 2 * Hk) * hd * BYTES,
                       deps=(prev,))
            nodes.append(qkv)
            # one HMM-type1 acc computes QK^T -> softmax -> PV: the
            # scores matrix never leaves the accelerator (paper Fig. 9).
            bmm = Node(len(nodes), f"L{li}.attn_bmm", "block", "attn",
                       role="attn_bmm",
                       mm=[MatmulShape(S * cf, hd, eff_kv, count=B * H,
                                       tp_dim="count"),
                           MatmulShape(S * cf, eff_kv, hd, count=B * H,
                                       tp_dim="count")],
                       vpu_flops=5.0 * B * H * S * eff_kv * cf,
                       act_in=qkv.act_out, act_out=tok * H * hd * BYTES,
                       state_bytes=(2 * B * eff_kv * Hk * hd * BYTES
                                    if decode else 0),
                       deps=(qkv.idx,))
            nodes.append(bmm)
            wo = Node(len(nodes), f"L{li}.wo", "block", "attn", role="wo",
                      mm=[MatmulShape(tok, H * hd, d, tp_dim="k")],
                      act_in=bmm.act_out, act_out=act,
                      weight_bytes=H * hd * d * BYTES, deps=(bmm.idx,))
            nodes.append(wo)
            prev = wo.idx
        else:
            n = _block_node(cfg, BlockSpec(blk.mixer, "none"), len(nodes),
                            f"L{li}.{blk.mixer}", B, S, kv_len, decode,
                            (prev,))
            n.role = blk.mixer
            nodes.append(n)
            prev = n.idx
        if blk.ffn != "none":
            mm2, vpu2, w2 = _ffn(cfg, blk, B, S)
            if blk.ffn == "dense":
                ff = cfg.d_ff
                n_in = 2 if cfg.gated_mlp else 1
                fin = Node(len(nodes), f"L{li}.ffn_in", "block", blk.mixer,
                           role="ffn_in",
                           mm=[MatmulShape(tok, d, ff, tp_dim="n")] * n_in,
                           vpu_flops=4.0 * tok * ff + 3 * tok * d,
                           act_in=act, act_out=tok * ff * BYTES,
                           weight_bytes=n_in * d * ff * BYTES, deps=(prev,))
                nodes.append(fin)
                fout = Node(len(nodes), f"L{li}.ffn_out", "block", blk.mixer,
                            role="ffn_out",
                            mm=[MatmulShape(tok, ff, d, tp_dim="k")],
                            vpu_flops=3 * tok * d,
                            act_in=fin.act_out, act_out=act,
                            weight_bytes=ff * d * BYTES, deps=(fin.idx,))
                nodes.append(fout)
                prev = fout.idx
            else:
                n = Node(len(nodes), f"L{li}.moe", "block", blk.mixer,
                         role="moe", mm=mm2, vpu_flops=vpu2, act_in=act,
                         act_out=act, weight_bytes=w2, deps=(prev,))
                nodes.append(n)
                prev = n.idx
    head_tok = B if cfg.family == "vision" else tok
    nodes.append(Node(len(nodes), "head", "head", role="head",
                      mm=[MatmulShape(head_tok, d, cfg.vocab_size,
                                      tp_dim="n")],
                      act_in=act, vpu_flops=5 * head_tok * cfg.vocab_size,
                      weight_bytes=0 if cfg.tie_embeddings
                      else d * cfg.vocab_size * BYTES,
                      deps=(prev,)))
    return Graph(cfg, shape, nodes, train=train)


def build_graph(cfg: ModelConfig, shape: ShapeConfig,
                granularity: str = "block") -> Graph:
    """One node per block + embed + head; decode shapes build the per-step
    graph (S=1, kv_len=shape.seq_len).  granularity='op' splits attention
    blocks into per-op nodes (paper Fig. 4) — used by the paper-platform
    benchmarks."""
    if granularity == "op":
        return build_op_graph(cfg, shape)
    B = shape.global_batch
    decode = shape.is_decode
    S = 1 if decode else shape.seq_len
    kv_len = shape.seq_len
    train = shape.kind == "train"

    nodes: List[Node] = []
    act = B * S * cfg.d_model * BYTES

    if cfg.family == "audio" and not decode:
        # encoder stack over S frames, decoder over S//4 tokens w/ cross-attn
        S_dec = max(S // AUDIO_DECODER_RATIO, 8)
        for i in range(cfg.encoder_layers):
            nodes.append(_block_node(cfg, cfg.block_pattern[0], len(nodes),
                                     f"enc{i}", B, S, S, False,
                                     (len(nodes) - 1,) if nodes else ()))
        enc_last = len(nodes) - 1
        emb = Node(len(nodes), "dec_embed", "embed",
                   act_out=B * S_dec * cfg.d_model * BYTES,
                   weight_bytes=cfg.vocab_size * cfg.d_model * BYTES,
                   vpu_flops=B * S_dec * cfg.d_model, deps=())
        nodes.append(emb)
        prev = emb.idx
        for i in range(cfg.num_layers):
            n = _block_node(cfg, cfg.block_pattern[0], len(nodes),
                            f"dec{i}", B, S_dec, S_dec, False,
                            (prev, enc_last))
            # cross-attention adds q/o + bmm versus encoder length S
            d, H, Hk, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
                cfg.head_dim
            n.mm = n.mm + [
                MatmulShape(B * S_dec, d, H * hd, tp_dim="n"),
                MatmulShape(B * S, d, 2 * Hk * hd, tp_dim="n"),
                MatmulShape(S_dec, hd, S, count=B * H, tp_dim="count"),
                MatmulShape(S_dec, S, hd, count=B * H, tp_dim="count"),
                MatmulShape(B * S_dec, H * hd, d, tp_dim="k"),
            ]
            nodes.append(n)
            prev = n.idx
        head = Node(len(nodes), "head", "head",
                    mm=[MatmulShape(B * S_dec, cfg.d_model, cfg.vocab_size,
                                    tp_dim="n")],
                    act_in=B * S_dec * cfg.d_model * BYTES,
                    weight_bytes=0,  # tied
                    vpu_flops=5 * B * S_dec * cfg.vocab_size, deps=(prev,))
        nodes.append(head)
        return Graph(cfg, shape, nodes, train=train)

    # ---- decoder-only (all other families) ----
    emb_w = cfg.vocab_size * cfg.d_model * BYTES
    if cfg.family in ("vlm", "vision"):
        emb_w = 0   # embeddings provided by the (stubbed) frontend
    nodes.append(Node(0, "embed", "embed", act_out=act, weight_bytes=emb_w,
                      vpu_flops=B * S * cfg.d_model, deps=()))
    for li in range(cfg.num_layers):
        blk = cfg.block_pattern[li % len(cfg.block_pattern)]
        nodes.append(_block_node(cfg, blk, len(nodes), f"L{li}:{blk.mixer}",
                                 B, S, kv_len, decode, (len(nodes) - 1,)))
    head_tok = B if cfg.family == "vision" else B * S
    head_w = 0 if cfg.tie_embeddings else cfg.d_model * cfg.vocab_size * BYTES
    nodes.append(Node(len(nodes), "head", "head",
                      mm=[MatmulShape(head_tok, cfg.d_model, cfg.vocab_size,
                                      tp_dim="n")],
                      act_in=act, weight_bytes=head_w,
                      vpu_flops=5 * head_tok * cfg.vocab_size,
                      deps=(len(nodes) - 1,)))
    return Graph(cfg, shape, nodes, train=train)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS = 6·N_active·D for the roofline ratio (dense formula on
    active params; decode counts one token per batch item)."""
    g = build_graph(cfg, shape)
    # active params ≈ sum of per-layer matmul (k*n) sizes (weights actually
    # multiplied per token), so 6ND == 3 * sum(2*m*k*n) over weight matmuls.
    return g.total_mm_flops
