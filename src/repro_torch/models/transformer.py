"""Block assembly, the layer stack, and KV-cache layouts of the port.

The JAX package scans ``num_groups`` repetitions of the block pattern with
``lax.scan`` over parameters stacked on a leading group axis.  The port
keeps one parameter dict per group in a list and runs a Python loop over
them.  Cache leaves keep the JAX layout with the group axis leading --
dense ``(num_groups, B, W, Hkv, D)``, paged ``(num_groups, num_blocks + 1,
page, Hkv, D)`` -- and each layer reads and writes its group's slice in
place.

The port serves every block kind of the JAX package: the ``attn``,
``attn_global``, ``attn_local``, ``mamba``, ``mlstm`` and ``slstm``
mixers with dense, MoE or no FFN (``ffn="none"``: xLSTM's blocks carry
their own projections, and such a block has no ``norm2``/``ffn``), in
the llama-style and nemotron decoders, qwen2-moe and granite-moe, jamba,
gemma2 (post-block norms), xlstm-125m, qwen2-vl (M-RoPE, through
``positions``), the encoder-only ViTs (``causal=False``), and whisper's
encoder and decoder, whose blocks add cross-attention over the encoder's
output (``init_stack(cross=True)``; its K/V cached at prefill as
``{"cross_kv": {"k", "v"}}`` leaves of (num_groups, B, enc_len, Hkv,
D)); unknown mixers, FFNs and activations raise.  A recurrent block's
cache is its state, ``{"ssm_state": ...}`` f32 leaves of shape
(num_groups, B, ...): mamba's ``{"conv", "ssm"}``, mLSTM's ``{"C", "n",
"m"}``, sLSTM's ``{"c", "n", "h", "m"}``; a local-window block's is a
ring of ``min(max_seq, window_size)`` rows in the activation dtype.
Both stay dense per slot in either layout (a paged cache pages only the
global attention K/V).
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM

SERVED_MIXERS = ("attn", "attn_global", "attn_local", "mamba", "mlstm",
                 "slstm")
SERVED_FFNS = ("dense", "moe", "none")
# family -> the frontend stub it takes ("": token ids)
SERVED_FAMILIES = {"dense": "", "moe": "", "hybrid": "", "ssm": "",
                   "vlm": "vision", "vision": "vision", "audio": "audio"}
RECURRENT = {"mamba": (SSM.init_mamba, SSM.apply_mamba,
                       SSM.mamba_state_shape),
             "mlstm": (SSM.init_mlstm, SSM.apply_mlstm,
                       SSM.mlstm_state_shape),
             "slstm": (SSM.init_slstm, SSM.apply_slstm,
                       SSM.slstm_state_shape)}


def check_supported(cfg: ModelConfig):
    """Raise NotImplementedError for a config this port cannot build (an
    unknown mixer, FFN, family, norm or activation)."""
    if any(b.mixer not in SERVED_MIXERS or b.ffn not in SERVED_FFNS
           for b in cfg.block_pattern):
        raise NotImplementedError(
            f"{cfg.name}: the port serves {SERVED_MIXERS} mixers with "
            f"{SERVED_FFNS} FFNs only, got {cfg.block_pattern}")
    if SERVED_FAMILIES.get(cfg.family) != cfg.frontend \
            or cfg.norm_kind not in ("rmsnorm", "layernorm") \
            or cfg.mlp_activation not in ("silu", "relu2", "gelu"):
        raise NotImplementedError(
            f"{cfg.name}: the port serves GQA decoders (with qk-norm or "
            f"M-RoPE too), attention + mamba hybrids, xLSTM stacks, "
            f"encoder-only ViTs and whisper's encoder-decoder, with "
            f"RMSNorm or LayerNorm and a SiLU, GELU or squared-ReLU MLP, "
            f"gated or not")


# ---------------------------------------------------------------------------
# per-block init / apply
# ---------------------------------------------------------------------------

def init_block(generator, cfg: ModelConfig, blk: BlockSpec, device,
               cross: bool = False):
    mixer = (RECURRENT[blk.mixer][0](generator, cfg, device)
             if blk.mixer in RECURRENT
             else L.init_attention(generator, cfg, device))
    p = {"norm1": L.init_norm(cfg, device), "mixer": mixer}
    if cross:
        p["norm_x"] = L.init_norm(cfg, device)
        p["cross"] = L.init_attention(generator, cfg, device, cross=True)
    if blk.ffn != "none":
        p["norm2"] = L.init_norm(cfg, device)
        p["ffn"] = (L.init_moe(generator, cfg, device) if blk.ffn == "moe"
                    else L.init_mlp(generator, cfg, device))
    if cfg.post_block_norm:
        p["post_norm1"] = L.init_norm(cfg, device)
        if blk.ffn != "none":
            p["post_norm2"] = L.init_norm(cfg, device)
    return p


def apply_block(p, x, cfg: ModelConfig, blk: BlockSpec, *, positions=None,
                causal=True, state=None, cache_index=None, enc_out=None,
                block_tables=None, write_tables=None,
                attend_cache: bool = False, par=None):
    """Returns (x, state, aux) -- ``state`` is the block's cache, written
    in place (None without a cache; a recurrent mixer's every state leaf
    overwritten); ``aux`` the MoE FFN's load-balance loss (0.0 for a
    dense FFN or none).  ``positions``, ``attend_cache``: see
    ``run_stack``.

    A block with cross-attention (``"cross"`` in ``p``) attends the
    encoder's output after its self-attention: with ``enc_out`` it
    projects the K/V fresh (and, given a cache, writes them into its
    ``cross_kv`` leaves: prefill); without, it reads the cached
    ``cross_kv`` (decode); with neither it raises, as JAX's does.
    ``par``: sharded training (see ``run_stack``)."""
    h = L.apply_norm(p["norm1"], x, cfg)
    if blk.mixer in RECURRENT:
        st = state["ssm_state"] if state else None
        h, new = RECURRENT[blk.mixer][1](p["mixer"], h, cfg, state=st,
                                         par=par)
        if st is not None:
            for name, leaf in new.items():
                st[name].copy_(leaf)
    else:
        h, _ = L.multi_head_attention(
            p["mixer"], h, cfg, positions=positions, causal=causal,
            window=cfg.window_size if blk.mixer == "attn_local" else 0,
            kv_cache=state.get("kv") if state else None,
            cache_index=cache_index, block_tables=block_tables,
            write_tables=write_tables, attend_cache=attend_cache, par=par)
    if cfg.post_block_norm:
        h = L.apply_norm(p["post_norm1"], h, cfg)
    x = x + h
    if "cross" in p:
        h = L.apply_norm(p["norm_x"], x, cfg)
        if enc_out is not None and L.tensor_parallel(p["cross"], cfg, par):
            # the rank's heads, K/V from its wk/wv columns (no cache
            # under par: run_stack refuses one)
            kv = {"kv_source": enc_out, "par": par}
        elif enc_out is not None:
            ck, cv = L.cross_kv(p["cross"], enc_out, cfg)
            if state is not None:
                if "cross_kv" not in state:
                    raise ValueError("a cross-attention block's cache needs "
                                     "cross_kv leaves (make_cache(enc_len=))")
                state["cross_kv"]["k"].copy_(ck)
                state["cross_kv"]["v"].copy_(cv)
            kv = {"precomputed_kv": (ck, cv)}
        elif state is not None and "cross_kv" in state:
            kv = {"precomputed_kv": (state["cross_kv"]["k"],
                                     state["cross_kv"]["v"])}
        else:
            raise ValueError("cross-attention block needs enc_out or cache")
        h, _ = L.multi_head_attention(p["cross"], h, cfg, causal=False,
                                      use_rope=False, **kv)
        x = x + h
    aux = 0.0
    if blk.ffn == "none":
        return x, state, aux
    h = L.apply_norm(p["norm2"], x, cfg)
    if blk.ffn == "moe":
        h, aux = L.apply_moe(p["ffn"], h, cfg, par)
    else:
        h = L.apply_mlp(p["ffn"], h, cfg, par)
    if cfg.post_block_norm:
        h = L.apply_norm(p["post_norm2"], h, cfg)
    return x + h, state, aux


def group_view(cache, g: int):
    """Group ``g``'s slice of every cache leaf (views: writes land in the
    full cache)."""
    return {bk: {key: {n: t[g] for n, t in leaf.items()}
                 for key, leaf in sub.items()}
            for bk, sub in cache.items()}


def run_stack(stack_params: List[Dict[str, Any]], x, cfg: ModelConfig, *,
              positions=None, causal: bool = True, cache=None,
              cache_index=None, enc_out=None, block_tables=None,
              write_tables=None, attend_cache: bool = False,
              remat: bool = False, group_mask=None, group_ids=None,
              par=None, stack: str = "stack"):
    """Run every group of ``stack_params`` in order against the cache
    leaves' matching group entries (a plan stage passes its group slice of
    both).  Returns (x, cache, aux), aux the sum of the MoE layers'
    load-balance losses (the float 0.0 without MoE layers).

    positions: explicit RoPE positions, (B, S) or M-RoPE's (3, B, S)
    (qwen2-vl); they rotate q and k only, and every mask keeps the
    positions the cache offset gives.  None: positions from
    ``cache_index``.  causal=False: bidirectional self-attention (the
    encoders).  enc_out: the encoder's output, which cross-attention
    blocks attend (see ``apply_block``).

    attend_cache: chunked-prefill continuation -- attention blocks attend
    the tokens already in a dense ``cache`` (scalar ``cache_index`` = their
    count) beside the fresh chunk; recurrent blocks continue from the
    cached state either way, and a paged prefill always attends every
    mapped page.

    remat: each group's body runs under ``torch.utils.checkpoint``
    (non-reentrant), which keeps only the group's inputs and recomputes
    its activations in the backward pass: JAX's ``jax.checkpoint`` with
    the ``nothing_saveable`` policy.  For the stateless training forward
    (no cache: a recompute would write the cache twice).

    group_mask: one 0/1 entry a group, on the host (a sequence, a numpy
    array or a CPU tensor: reading a CUDA tensor here would sync).  A
    group at 0 passes ``x`` and ``aux`` through unchanged and launches
    nothing, where JAX's scan computes it and selects; this is how the
    plan executor runs a stage padded to the plan's ``max_groups``.  For
    the stateless forward only (no cache), as in JAX.

    group_ids: the model's group index of each entry (default 0, 1, ...;
    a plan stage passes its row of ``plan.group_index_matrix()``): FSDP's
    ``par.gather_group`` takes the group by that index.

    par: a ``sharding.Parallel`` (sharded training, or a plan mesh rank
    with ``group_mask``; no cache).  Each
    group's leaves are this rank's shards, and a leaf the specs put on a
    data axis (FSDP) is all-gathered just before its group runs
    (``par.gather_group``, the specs under ``stack``): its gradient is
    reduce-scattered back by the gather's backward, and under remat the
    gather is redone in the recompute, so at most one group is gathered
    at once.  Over ``model`` > 1 every block is tensor parallel on the
    rank's shards: attention (self and cross), the dense and MoE FFNs,
    mamba, mLSTM and sLSTM (``models/ssm.py``)."""
    if remat and cache is not None:
        raise ValueError("remat recomputes a stateless forward: no cache")
    ids = list(range(len(stack_params))) if group_ids is None \
        else [int(g) for g in group_ids]
    if len(ids) != len(stack_params):
        raise ValueError(f"group_ids has {len(ids)} entries for "
                         f"{len(stack_params)} groups")
    if group_mask is not None:
        if cache is not None:
            raise ValueError("group_mask is for the stateless pipelined "
                             "forward path: no cache")
        if isinstance(group_mask, torch.Tensor) \
                and group_mask.device.type != "cpu":
            raise TypeError("group_mask must live on the host: reading a "
                            f"{group_mask.device} tensor would sync")
        if len(group_mask) != len(stack_params):
            raise ValueError(f"group_mask has {len(group_mask)} entries for "
                             f"{len(stack_params)} groups")
        live = [float(m) > 0 for m in group_mask]
        ids = [g for g, on in zip(ids, live) if on]
        stack_params = [gp for gp, on in zip(stack_params, live) if on]
    if par is not None and cache is not None:
        raise NotImplementedError("sharded training runs the stateless "
                                  "forward: no cache")

    def group(gp, gc, x, aux, g=0):
        if par is not None:
            gp = par.gather_group(gp, g, stack)
        for j, blk in enumerate(cfg.block_pattern):
            x, _, a = apply_block(
                gp[f"b{j}"], x, cfg, blk, positions=positions,
                causal=causal,
                state=gc[f"b{j}"] if gc is not None else None,
                cache_index=cache_index, enc_out=enc_out,
                block_tables=block_tables,
                write_tables=write_tables, attend_cache=attend_cache,
                par=par)
            aux = aux + a
        return x, aux

    aux = 0.0
    for i, (g, gp) in enumerate(zip(ids, stack_params)):
        if remat:
            x, aux = checkpoint(group, gp, None, x, aux, g,
                                use_reentrant=False)
        else:
            gc = group_view(cache, i) if cache is not None else None
            x, aux = group(gp, gc, x, aux, g)
    return x, cache, aux


# ---------------------------------------------------------------------------
# cache layouts
# ---------------------------------------------------------------------------

def _is_global_attn(mixer: str) -> bool:
    return mixer.startswith("attn") and mixer != "attn_local"


def block_state_shapes(cfg: ModelConfig, blk: BlockSpec, batch: int,
                       max_seq: int, enc_len: int = 0):
    """One pattern slot's cache leaf shapes, without the group axis; with
    ``enc_len``, also the cross-attention K/V over that many encoder
    frames."""
    if blk.mixer in RECURRENT:
        out = {"ssm_state": RECURRENT[blk.mixer][2](cfg, batch)}
    else:
        # a local-window block keeps a ring of its window's last rows
        rows = (min(max_seq, cfg.window_size) if blk.mixer == "attn_local"
                else max_seq)
        shp = (batch, rows, cfg.num_kv_heads, cfg.head_dim)
        out = {"kv": {"k": shp, "v": shp}}
    if enc_len:
        shp = (batch, enc_len, cfg.num_kv_heads, cfg.head_dim)
        out["cross_kv"] = {"k": shp, "v": shp}
    return out


def _dense_block_leaves(cfg: ModelConfig, blk: BlockSpec, batch: int,
                        max_seq: int, dt, device, enc_len: int = 0):
    """One pattern slot's dense leaves, zero-filled, group axis leading:
    K/V (self and cross) in ``dt``, recurrent state in f32 (as on the JAX
    side)."""
    return {key: {n: torch.zeros((cfg.num_groups,) + shp,
                                 dtype=(dt if key in ("kv", "cross_kv")
                                        else torch.float32),
                                 device=device)
                  for n, shp in val.items()}
            for key, val in block_state_shapes(cfg, blk, batch, max_seq,
                                               enc_len).items()}


def make_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               enc_len: int = 0, dtype=None, device="cuda"):
    """Dense decode cache: per pattern slot ``{"kv": {"k", "v"}}`` leaves of
    shape (num_groups, batch, max_seq, Hkv, D) (a local-window slot's ring
    holds min(max_seq, window_size) rows), or a recurrent slot's
    ``{"ssm_state": ...}`` f32 leaves, zero-filled (an xLSTM stabilizer
    ``m`` too, as JAX's ``jnp.zeros`` cache has it); with ``enc_len``
    (whisper's decoder) also ``{"cross_kv": {"k", "v"}}`` of (num_groups,
    batch, enc_len, Hkv, D)."""
    dt = getattr(torch, dtype or cfg.dtype)
    return {f"b{j}": _dense_block_leaves(cfg, blk, batch, max_seq, dt,
                                         device, enc_len)
            for j, blk in enumerate(cfg.block_pattern)}


def has_paged_layers(cfg: ModelConfig) -> bool:
    return any(_is_global_attn(b.mixer) for b in cfg.block_pattern)


def make_paged_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
                     page_size: int, num_blocks: int, dtype=None,
                     device="cuda", kv_dtype: str = "fp"):
    """Pool-backed cache: per attention slot ``{"kv": {"k_pages",
    "v_pages"}}`` of shape (num_groups, num_blocks + 1, page_size, Hkv, D);
    mamba slots keep their dense per-slot state leaves (as ``make_cache``).
    The extra page is the write sink the manager's sentinel
    (``num_blocks``) indexes: writes that cannot be dropped land there,
    and no table maps it for reading.  Local-window rings stay dense and
    keep the activation dtype on int8 pools too, as JAX's do.

    kv_dtype: "fp" stores K/V at ``dtype``; "int8" stores int8 rows plus
    per-(row, kv head) f32 dequant scales, ``k_scales``/``v_scales`` of
    shape (num_groups, num_blocks + 1, page_size, Hkv)
    (``paged_kv_capacity_ratio`` more tokens per byte)."""
    if max_seq % page_size:
        raise ValueError(f"max_seq={max_seq} must be a multiple of "
                         f"page_size={page_size}")
    if kv_dtype not in ("fp", "int8"):
        raise ValueError(f"kv_dtype={kv_dtype!r} must be 'fp' or 'int8'")
    dt = getattr(torch, dtype or cfg.dtype)
    pool_dt = torch.int8 if kv_dtype == "int8" else dt
    shp = (cfg.num_groups, num_blocks + 1, page_size, cfg.num_kv_heads,
           cfg.head_dim)

    def leaves():
        kv = {"k_pages": torch.zeros(shp, dtype=pool_dt, device=device),
              "v_pages": torch.zeros(shp, dtype=pool_dt, device=device)}
        if kv_dtype == "int8":
            for n in ("k_scales", "v_scales"):
                kv[n] = torch.zeros(shp[:-1], dtype=torch.float32,
                                    device=device)
        return kv

    return {f"b{j}": ({"kv": leaves()} if _is_global_attn(blk.mixer)
                      else _dense_block_leaves(cfg, blk, batch, max_seq,
                                               dt, device))
            for j, blk in enumerate(cfg.block_pattern)}


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


def make_prefill_part(cfg: ModelConfig, max_seq: int, *, device="cuda"):
    """The dense remainder of a paged prefill: zeroed batch-1 state for
    every mamba slot, and an empty entry for every global-attention slot
    (its K/V streams into the pool)."""
    check_supported(cfg)
    dt = getattr(torch, cfg.dtype)
    return {f"b{j}": ({} if _is_global_attn(blk.mixer)
                      else _dense_block_leaves(cfg, blk, 1, max_seq, dt,
                                               device))
            for j, blk in enumerate(cfg.block_pattern)}


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


def slice_cache_groups(cache, first_group: int, n_groups: int):
    """A plan stage's view of a cache: every leaf's group range
    [first_group, first_group + n_groups) on the leading axis, dense and
    paged leaves alike.  Views, not copies: the stage's writes land in
    ``cache``.

    The JAX package also needs ``merge_cache_groups``,
    ``concat_cache_groups`` and ``rebind_pool_leaves`` (and its engine
    ``_share_pool``) because its steps return fresh, donated buffers that
    must be stitched back and re-aliased across replicas; the port writes
    in place, so a stage's or a replica's writes are already in the one
    cache and none of those exist here."""
    return {bk: {key: {n: t[first_group:first_group + n_groups]
                       for n, t in leaf.items()}
                 for key, leaf in sub.items()}
            for bk, sub in cache.items()}


def slice_cache_slots(cache, first: int, n: int):
    """A decode replica's view of a cache: dense leaves' slot range
    [first, first + n) on axis 1; paged pool leaves pass through whole (a
    slot's paged state is its block-table row, and every replica fronts
    the one pool).  Views, not copies."""
    return {bk: (sub if _block_is_paged(sub)
                 else {key: {nm: t[:, first:first + n]
                             for nm, t in leaf.items()}
                       for key, leaf in sub.items()})
            for bk, sub in cache.items()}


def extract_dense_slot(cache, slot: int):
    """Batch row ``slot`` of the cache's dense leaves only, as a part cache
    (views), or ``{}`` for an all-global-attention paged model.  This is
    the slot-migration read: a slot's paged state moves by block-table
    handoff, only its dense row (a hybrid's mamba state; every leaf of a
    dense cache) moves on the device, written into the destination row by
    ``scatter_cache_slot`` in place.

    The replicas' caches are views of the engine's one cache, so a
    migration between replicas or plans is that one row copy: the JAX
    package's ``concat_cache_slots`` (re-joining replica partitions),
    ``scatter_prefill_part`` and engine ``_share_pool`` (re-aliasing
    donated pools) have no counterpart here."""
    return {bk: {key: {n: t[:, slot:slot + 1] for n, t in leaf.items()}
                 for key, leaf in sub.items()}
            for bk, sub in cache.items() if not _block_is_paged(sub)}


def copy_cache_pages(full_cache, src: int, dst: int):
    """Copy physical page ``src`` onto ``dst`` in every paged leaf, in
    place (the device half of copy-on-write)."""
    for sub in full_cache.values():
        if _block_is_paged(sub):
            for t in sub["kv"].values():
                t[:, dst] = t[:, min(max(src, 0), t.shape[1] - 1)]
    return full_cache


def init_stack(generator, cfg: ModelConfig, device, cross: bool = False):
    """One block dict a group (``cfg.num_groups`` of them); ``cross``:
    with cross-attention (whisper's decoder)."""
    return [{f"b{j}": init_block(generator, cfg, blk, device, cross=cross)
             for j, blk in enumerate(cfg.block_pattern)}
            for _ in range(cfg.num_groups)]
