"""Block assembly, the layer stack, and KV-cache layouts of the port.

The JAX package scans ``num_groups`` repetitions of the block pattern with
``lax.scan`` over parameters stacked on a leading group axis.  The port
keeps one parameter dict per group in a list and runs a Python loop over
them.  Cache leaves keep the JAX layout with the group axis leading --
dense ``(num_groups, B, W, Hkv, D)``, paged ``(num_groups, num_blocks + 1,
page, Hkv, D)`` -- and each layer reads and writes its group's slice in
place.

The port serves ``BlockSpec("attn", "dense")`` stacks (the yi-6b family);
other block kinds raise.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.models import layers as L


def check_supported(cfg: ModelConfig):
    """Raise NotImplementedError for what this port does not serve yet."""
    if any(b != BlockSpec("attn", "dense") for b in cfg.block_pattern):
        raise NotImplementedError(
            f"{cfg.name}: the port serves attn + dense blocks only, got "
            f"{cfg.block_pattern}")
    if cfg.family != "dense" or cfg.mrope_sections or cfg.qk_norm \
            or cfg.post_block_norm or cfg.frontend or cfg.tie_embeddings \
            or cfg.final_logit_softcap or cfg.norm_kind != "rmsnorm" \
            or cfg.mlp_activation != "silu" or not cfg.gated_mlp:
        raise NotImplementedError(
            f"{cfg.name}: the port serves dense GQA decoders with RMSNorm, "
            f"a gated SiLU MLP and an untied LM head")


# ---------------------------------------------------------------------------
# per-block init / apply
# ---------------------------------------------------------------------------

def init_block(generator, cfg: ModelConfig, blk: BlockSpec, device):
    return {"norm1": L.init_norm(cfg, device),
            "mixer": L.init_attention(generator, cfg, device),
            "norm2": L.init_norm(cfg, device),
            "ffn": L.init_mlp(generator, cfg, device)}


def apply_block(p, x, cfg: ModelConfig, blk: BlockSpec, *, state=None,
                cache_index=None, block_tables=None, write_tables=None):
    """Returns (x, state) -- ``state`` is the block's cache, written in
    place (None without a cache)."""
    h = L.apply_norm(p["norm1"], x, cfg)
    h, kv = L.multi_head_attention(
        p["mixer"], h, cfg, kv_cache=state.get("kv") if state else None,
        cache_index=cache_index, block_tables=block_tables,
        write_tables=write_tables)
    x = x + h
    h = L.apply_norm(p["norm2"], x, cfg)
    x = x + L.apply_mlp(p["ffn"], h, cfg)
    return x, ({"kv": kv} if kv is not None else None)


def group_view(cache, g: int):
    """Group ``g``'s slice of every cache leaf (views: writes land in the
    full cache)."""
    return {bk: {key: {n: t[g] for n, t in leaf.items()}
                 for key, leaf in sub.items()}
            for bk, sub in cache.items()}


def run_stack(stack_params: List[Dict[str, Any]], x, cfg: ModelConfig, *,
              cache=None, cache_index=None, block_tables=None,
              write_tables=None):
    """Run every group of the stack in order.  Returns (x, cache)."""
    for g, gp in enumerate(stack_params):
        gc = group_view(cache, g) if cache is not None else None
        for j, blk in enumerate(cfg.block_pattern):
            x, _ = apply_block(
                gp[f"b{j}"], x, cfg, blk,
                state=gc[f"b{j}"] if gc is not None else None,
                cache_index=cache_index, block_tables=block_tables,
                write_tables=write_tables)
    return x, cache


# ---------------------------------------------------------------------------
# cache layouts
# ---------------------------------------------------------------------------

def _is_global_attn(mixer: str) -> bool:
    return mixer.startswith("attn") and mixer != "attn_local"


def make_cache(cfg: ModelConfig, batch: int, max_seq: int, *, dtype=None,
               device="cuda"):
    """Dense decode cache: per pattern slot ``{"kv": {"k", "v"}}`` leaves of
    shape (num_groups, batch, max_seq, Hkv, D), zero-filled."""
    dt = getattr(torch, dtype or cfg.dtype)
    shp = (cfg.num_groups, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return {f"b{j}": {"kv": {"k": torch.zeros(shp, dtype=dt, device=device),
                             "v": torch.zeros(shp, dtype=dt, device=device)}}
            for j, _ in enumerate(cfg.block_pattern)}


def has_paged_layers(cfg: ModelConfig) -> bool:
    return any(_is_global_attn(b.mixer) for b in cfg.block_pattern)


def make_paged_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
                     page_size: int, num_blocks: int, dtype=None,
                     device="cuda", kv_dtype: str = "fp"):
    """Pool-backed cache: per pattern slot ``{"kv": {"k_pages",
    "v_pages"}}`` of shape (num_groups, num_blocks + 1, page_size, Hkv, D).
    The extra page is the write sink the manager's sentinel
    (``num_blocks``) indexes: writes that cannot be dropped land there,
    and no table maps it for reading.

    kv_dtype: "fp" stores K/V at ``dtype``; "int8" stores int8 rows plus
    per-(row, kv head) f32 dequant scales, ``k_scales``/``v_scales`` of
    shape (num_groups, num_blocks + 1, page_size, Hkv)
    (``paged_kv_capacity_ratio`` more tokens per byte)."""
    if max_seq % page_size:
        raise ValueError(f"max_seq={max_seq} must be a multiple of "
                         f"page_size={page_size}")
    if kv_dtype not in ("fp", "int8"):
        raise ValueError(f"kv_dtype={kv_dtype!r} must be 'fp' or 'int8'")
    dt = torch.int8 if kv_dtype == "int8" else getattr(torch,
                                                       dtype or cfg.dtype)
    shp = (cfg.num_groups, num_blocks + 1, page_size, cfg.num_kv_heads,
           cfg.head_dim)

    def leaves():
        kv = {"k_pages": torch.zeros(shp, dtype=dt, device=device),
              "v_pages": torch.zeros(shp, dtype=dt, device=device)}
        if kv_dtype == "int8":
            for n in ("k_scales", "v_scales"):
                kv[n] = torch.zeros(shp[:-1], dtype=torch.float32,
                                    device=device)
        return kv

    return {f"b{j}": {"kv": leaves()}
            for j, _ in enumerate(cfg.block_pattern)}


def paged_kv_capacity_ratio(cfg: ModelConfig, kv_dtype: str,
                            dtype=None) -> float:
    """Tokens-per-byte multiplier of a ``kv_dtype`` pool over the fp
    layout at the same byte budget: int8 rows cost ``head_dim`` bytes plus
    one f32 scale against ``head_dim * itemsize`` fp bytes (1.94x for bf16
    pools at head_dim 128)."""
    if kv_dtype == "fp":
        return 1.0
    itemsize = getattr(torch, dtype or cfg.dtype).itemsize
    d = cfg.head_dim
    return (d * itemsize) / float(d + 4)


def _block_is_paged(sub) -> bool:
    return "kv" in sub and "k_pages" in sub["kv"]


def supports_prefix_compute_reuse(cfg: ModelConfig) -> bool:
    """A warm prefix may skip its prefill compute when every mixer is
    global attention and no FFN is MoE (see the JAX twin)."""
    return all(_is_global_attn(b.mixer) and b.ffn != "moe"
               for b in cfg.block_pattern)


def make_prefill_part(cfg: ModelConfig, max_seq: int):
    """The dense remainder of a paged prefill: empty for every
    global-attention slot (its K/V streams into the pool), which is every
    slot of the stacks the port serves."""
    check_supported(cfg)
    return {f"b{j}": {} for j, _ in enumerate(cfg.block_pattern)}


def combine_prefill_parts(paged_cache, dense_part):
    """The cache view a paged prefill runs against: paged blocks bring
    their live pools, other blocks their batch-1 dense part."""
    return {bk: (sub if _block_is_paged(sub) else dense_part[bk])
            for bk, sub in paged_cache.items()}


def scatter_cache_slot(full_cache, part_cache, slot: int):
    """Write a small-batch cache into batch rows [slot, slot + b) of a
    slot-indexed dense cache (leaves (num_groups, batch, ...)), in place."""
    for bk, sub in part_cache.items():
        for key, leaf in sub.items():
            for n, t in leaf.items():
                full = full_cache[bk][key][n]
                full[:, slot:slot + t.shape[1]] = t.to(full.dtype)
    return full_cache


def merge_prefill_view(full_cache, new_view, slot: int):
    """Land a finished paged prefill: paged blocks already hold their K/V
    in the shared pools (written in place), dense blocks scatter their
    batch-1 part into row ``slot``."""
    dense = {bk: v for bk, v in new_view.items()
             if not _block_is_paged(full_cache[bk])}
    return scatter_cache_slot(full_cache, dense, slot)


def copy_cache_pages(full_cache, src: int, dst: int):
    """Copy physical page ``src`` onto ``dst`` in every paged leaf, in
    place (the device half of copy-on-write)."""
    for sub in full_cache.values():
        if _block_is_paged(sub):
            for t in sub["kv"].values():
                t[:, dst] = t[:, min(max(src, 0), t.shape[1] - 1)]
    return full_cache


def init_stack(generator, cfg: ModelConfig, device):
    return [{f"b{j}": init_block(generator, cfg, blk, device)
             for j, blk in enumerate(cfg.block_pattern)}
            for _ in range(cfg.num_groups)]
