"""Model facade of the port: init / forward / prefill / decode.

``build_model(cfg, device)`` returns a ``Model`` whose methods are plain
functions of (params, inputs), like the JAX facade's, for the dense GQA
decoders the port serves.  Params are nested dicts of tensors on
``model.device``: ``{"embed": {"table"}, "stack": [per-group block dicts],
"final_norm": {"scale"}, "head": {"w"}}``.  Inputs may be numpy arrays or
tensors; they are moved to the model's device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def _tokens(x, device):
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x.astype(np.int64))
    return torch.as_tensor(x, device=device).long()


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: str = "cuda"

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        """Random weights drawn on ``self.device`` from ``generator`` with
        the JAX init scheme (dense N(0,1)/sqrt(fan_in), norm scales 1).
        The numbers differ from ``jax.random``'s: to run JAX's weights, use
        ``repro_torch.bridge.params_from_numpy``."""
        cfg, dev = self.cfg, self.device
        return {"embed": L.init_embedding(generator, cfg, dev),
                "stack": T.init_stack(generator, cfg, dev),
                "final_norm": L.init_norm(cfg, dev),
                "head": {"w": L.dense_init(
                    generator, (cfg.d_model, cfg.vocab_size), cfg.d_model,
                    getattr(torch, cfg.param_dtype), dev)}}

    # --------------------------------------------------------------- forward
    def _lm_hidden(self, params, x, *, cache=None, cache_index=None,
                   block_tables=None, write_tables=None):
        x, cache = T.run_stack(params["stack"], x, self.cfg, cache=cache,
                               cache_index=cache_index,
                               block_tables=block_tables,
                               write_tables=write_tables)
        return L.apply_norm(params["final_norm"], x, self.cfg), cache

    def _embed(self, params, tokens):
        dt = getattr(torch, self.cfg.dtype)
        return L.embed(params["embed"], _tokens(tokens, self.device),
                       self.cfg).to(dt)

    def _head(self, params, x):
        return L.logits_head(params["head"], x, self.cfg)

    def forward(self, params, batch):
        """Full causal forward over ``batch["tokens"]`` (B, S) ->
        (logits (B, S, V) f32, aux_loss 0)."""
        x = self._embed(params, batch["tokens"])
        hidden, _ = self._lm_hidden(params, x)
        return self._head(params, hidden), torch.zeros((), device=x.device)

    # --------------------------------------------------------------- serving
    def init_cache(self, batch: int, max_seq: int):
        return T.make_cache(self.cfg, batch, max_seq, device=self.device)

    def init_paged_cache(self, batch: int, max_seq: int, *, page_size: int,
                         num_blocks: int, kv_dtype: str = "fp"):
        return T.make_paged_cache(self.cfg, batch, max_seq,
                                  page_size=page_size, num_blocks=num_blocks,
                                  device=self.device, kv_dtype=kv_dtype)

    def prefill(self, params, batch, max_seq: int):
        """Process the prompt into a fresh dense cache; returns
        (logits at the last position (B, 1, V), cache)."""
        x = self._embed(params, batch["tokens"])
        cache = self.init_cache(x.shape[0], max_seq)
        hidden, cache = self._lm_hidden(params, x, cache=cache,
                                        cache_index=0)
        return self._head(params, hidden[:, -1:]), cache

    def prefill_one(self, params, tokens, length: int, max_seq: int):
        """Batch-1 prefill of a right-padded prompt (1, P) whose true
        length is ``length``; returns (logits at the last valid position
        (1, 1, V), the batch-1 dense cache)."""
        x = self._embed(params, tokens)
        cache = self.init_cache(x.shape[0], max_seq)
        hidden, cache = self._lm_hidden(params, x, cache=cache,
                                        cache_index=0)
        last = hidden[:, int(length) - 1:int(length)]
        return self._head(params, last), cache

    def prefill_into_slot(self, params, full_cache, tokens, slot: int,
                          length: int, max_seq: int):
        """``prefill_one``, then its cache written into batch row ``slot``
        of ``full_cache`` (in place).  Returns (logits, full_cache)."""
        logits, cache = self.prefill_one(params, tokens, length, max_seq)
        return logits, T.scatter_cache_slot(full_cache, cache, int(slot))

    def prefill_suffix_paged(self, params, full_cache, tokens, slot: int,
                             offset: int, length: int, max_seq: int,
                             block_tables, write_tables):
        """Paged prefill into slot ``slot``: the right-padded prompt suffix
        (1, S) streams straight into the pool.  ``offset`` counts the warm
        prefix tokens already in shared pages (0 on a cold admission),
        ``length`` the true suffix length; ``block_tables`` (1, NB) maps
        every logical block for the gather, ``write_tables`` (1, NB) only
        the fresh ones (sentinel elsewhere).  Returns (logits at the last
        valid suffix position (1, 1, V), full_cache written in place)."""
        x = self._embed(params, tokens)
        view = T.combine_prefill_parts(
            full_cache, T.make_prefill_part(self.cfg, max_seq))
        dev = self.device
        hidden, view = self._lm_hidden(
            params, x, cache=view, cache_index=int(offset),
            block_tables=torch.as_tensor(block_tables, device=dev),
            write_tables=torch.as_tensor(write_tables, device=dev))
        last = hidden[:, int(length) - 1:int(length)]
        return self._head(params, last), T.merge_prefill_view(
            full_cache, view, int(slot))

    def decode_step(self, params, cache, tokens, cache_index,
                    block_tables=None):
        """One decode step.  tokens (B, S): S = 1 for plain decode, or
        S = K+1 for a speculative-verify window (current token + K drafted
        tokens per slot, scored in one step, at per-slot ``cache_index``).
        ``cache_index`` an int (all rows in lock-step) or a (B,) vector of
        per-slot positions; ``block_tables`` (B, NB) when ``cache`` is
        pool-backed.  Returns (logits (B, S, V), cache written in place)."""
        x = self._embed(params, tokens)
        if not isinstance(cache_index, int):
            cache_index = torch.as_tensor(cache_index, device=self.device)
            if cache_index.dim() == 0:
                cache_index = int(cache_index)
        if block_tables is not None:
            block_tables = torch.as_tensor(block_tables, device=self.device)
        hidden, cache = self._lm_hidden(params, x, cache=cache,
                                        cache_index=cache_index,
                                        block_tables=block_tables)
        return self._head(params, hidden), cache

    def param_count(self, params) -> int:
        n = sum(t.numel() for k, sub in params.items() if k != "stack"
                for t in sub.values())
        for gp in params["stack"]:
            for blk in gp.values():
                n += sum(t.numel() for part in blk.values()
                         for t in part.values())
        return n


def build_model(cfg: ModelConfig, device: str = "cuda") -> Model:
    T.check_supported(cfg)
    return Model(cfg, device)
