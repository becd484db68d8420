"""Model facade of the port: init / forward / loss / prefill / decode.

``build_model(cfg, device)`` returns a ``Model`` whose methods are plain
functions of (params, inputs), like the JAX facade's (``loss`` too, with
the head fused with cross-entropy for large vocabularies, and
``remat``), for every family of the JAX package: the dense and MoE GQA
decoders, the attention + mamba hybrids, xLSTM (family ``ssm``), qwen2-vl (family ``vlm``: merged text +
patch ``embeds`` and M-RoPE ``positions`` of (3, B, S); its vision tower
a stub, as in JAX), the encoder-only ViTs (family ``vision``) and
whisper's encoder-decoder (family ``audio``).  Params are nested dicts
of tensors on ``model.device``, under the JAX facade's names:
  * LM families (vlm too): ``{"embed": {"table"}, "stack": [per-group
    block dicts],
    "final_norm": {"scale"} (and ``"bias"`` for LayerNorm), "head":
    {"w"}}``, without ``"head"`` when the config ties it to the embedding;
  * vision: ``{"pos_embed": (1, 256, D) f32, "cls": (1, 1, D) f32,
    "stack", "final_norm", "head"}``;
  * audio: ``{"enc_stack", "enc_norm", "embed", "stack"`` (blocks with
    cross-attention), ``"final_norm"}``, the head the embedding's
    transpose.
Inputs may be numpy arrays or tensors; they are moved to the model's
device.  As in JAX, the per-slot serving primitives (``prefill_one``,
``prefill_suffix_paged``) serve token-LM families only: vision, audio,
vlm and any M-RoPE config raise NotImplementedError there, and run
through ``forward``, ``prefill`` and ``decode_step``.

Sharded training: ``Model(cfg, device, par=Parallel(...))`` (what
``training.sharded_train_step`` builds) takes this rank's shards of the
params and batch rows, for every family; ``loss`` is then the global
loss (see there), and ``forward`` gives the rows' full logits (the
vocab-parallel head's blocks, or the ViT class head's, gathered over
``model``), as the plan runner's last stage uses it.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def _embeds(x, device, dtype):
    """Precomputed embeddings (the frontend stubs' input) on ``device`` in
    the activation dtype."""
    return torch.as_tensor(x).to(device=device).to(dtype)


def _positions(x, device):
    """Explicit positions ((B, S), or (3, B, S) for M-RoPE) as an int64
    tensor on ``device``, or None."""
    if x is None:
        return None
    return torch.as_tensor(x, device=device).long()


def _tokens(x, device):
    """Token ids as an int64 tensor on ``device``; a host array reaches a
    CUDA device through pinned memory without a host sync."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x.astype(np.int64))
        if torch.device(device).type == "cuda":
            return x.pin_memory().to(device, non_blocking=True)
    return torch.as_tensor(x, device=device).long()


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: str = "cuda"
    # sharded training: a ``sharding.Parallel`` (None: one process, whole
    # params)
    par: Any = None

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        """Random weights drawn on ``self.device`` from ``generator`` with
        the JAX init scheme (dense N(0,1)/sqrt(fan_in), norm scales 1).
        The numbers differ from ``jax.random``'s: to run JAX's weights, use
        ``repro_torch.bridge.params_from_numpy``."""
        cfg, dev = self.cfg, self.device
        if cfg.family == "audio":
            return {"enc_stack": T.init_stack(generator, cfg, dev),
                    "enc_norm": L.init_norm(cfg, dev),
                    "embed": L.init_embedding(generator, cfg, dev),
                    "stack": T.init_stack(generator, cfg, dev, cross=True),
                    "final_norm": L.init_norm(cfg, dev)}
        if cfg.family == "vision":
            d = cfg.d_model
            return {"pos_embed": 0.02 * torch.randn(
                        (1, 256, d), generator=generator,
                        dtype=torch.float32, device=dev),
                    "cls": torch.zeros((1, 1, d), dtype=torch.float32,
                                       device=dev),
                    "stack": T.init_stack(generator, cfg, dev),
                    "final_norm": L.init_norm(cfg, dev),
                    "head": {"w": L.dense_init(
                        generator, (d, cfg.vocab_size), d,
                        getattr(torch, cfg.param_dtype), dev)}}
        params = {"embed": L.init_embedding(generator, cfg, dev),
                  "stack": T.init_stack(generator, cfg, dev),
                  "final_norm": L.init_norm(cfg, dev)}
        if not cfg.tie_embeddings:
            params["head"] = {"w": L.dense_init(
                generator, (cfg.d_model, cfg.vocab_size), cfg.d_model,
                getattr(torch, cfg.param_dtype), dev)}
        return params

    # --------------------------------------------------------------- forward
    def _lm_hidden(self, params, x, *, positions=None, cache=None,
                   cache_index=None, block_tables=None, write_tables=None,
                   remat=False):
        """Returns (final-normed hidden, cache, aux)."""
        x, cache, aux = T.run_stack(params["stack"], x, self.cfg,
                                    positions=positions, cache=cache,
                                    cache_index=cache_index,
                                    block_tables=block_tables,
                                    write_tables=write_tables, remat=remat,
                                    par=self.par)
        return L.apply_norm(self._top(params, "final_norm"), x,
                            self.cfg), cache, aux

    def _lm_inputs(self, params, batch):
        """An LM batch's stack input and positions: ``batch["embeds"]``
        (B, S, D) in place of the embedded ``batch["tokens"]`` when given
        (qwen2-vl's merged text + patch embeddings), and
        ``batch.get("positions")`` on the device (None: from the cache
        offset)."""
        if "embeds" in batch:
            x = _embeds(batch["embeds"], self.device, self._dtype())
        else:
            x = self._embed(params, batch["tokens"])
        return x, _positions(batch.get("positions"), self.device)

    def _dtype(self):
        return getattr(torch, self.cfg.dtype)

    def _top(self, params, key):
        """``params[key]`` with its FSDP-sharded leaves gathered over the
        data axes (under ``par``; as it is otherwise)."""
        p = params.get(key)
        if self.par is None or p is None:
            return p
        if torch.is_tensor(p):
            return self.par.gathered((key,), p)
        return {n: self.par.gathered((key, n), t) for n, t in p.items()}

    def _embed(self, params, tokens):
        return L.embed(self._top(params, "embed"),
                       _tokens(tokens, self.device), self.cfg,
                       self.par).to(self._dtype())

    def _head(self, params, x):
        """f32 logits.  Under ``par`` with the vocabulary sharded over
        ``model``, each rank's block is all-gathered over ``model`` (no
        gradient flows back through the gather: ``Model.loss`` reduces
        the shards with ``vocab_parallel_xent`` instead)."""
        if self.par is None:
            return L.logits_head(params["embed"], params.get("head"), x,
                                 self.cfg)
        w = self._head_weight(params)
        out = L.logits_head({"table": w.t()}, None, x, self.cfg)
        if w.shape[1] != self.cfg.vocab_size:
            out = self.par.gather_plain(out, -1, "model")
        return out

    def _head_weight(self, params):
        """The LM head's (D, V) weight: its own, or the embedding table's
        transpose (a view) when tied (under ``par``: this rank's V block,
        gathered over the data axes)."""
        if self.cfg.tie_embeddings or params.get("head") is None:
            return self._top(params, "embed")["table"].t()
        return self._top(params, "head")["w"]

    def _use_chunked_ce(self) -> bool:
        """Whether ``loss`` takes the fused head + cross-entropy: a
        vocabulary of at least ``REPRO_CHUNKED_CE`` (default 65,536; 0
        turns it off), outside the vision family -- the variable JAX's
        loss reads, so that one setting drives both packages."""
        thresh = int(os.environ.get("REPRO_CHUNKED_CE", 65536))
        return bool(thresh) and self.cfg.vocab_size >= thresh \
            and self.cfg.family not in ("vision",)

    def forward(self, params, batch, *, remat: bool = False):
        """Full forward -> (logits f32, aux_loss: the MoE layers' summed
        load-balance loss, 0 without them).  LM families: causal over
        ``batch["tokens"]`` (B, S), or ``batch["embeds"]`` (B, S, D) in
        their place, at ``batch.get("positions")`` (vlm: (3, B, S)
        M-RoPE positions, required), logits (B, S, V).  vision:
        ``batch["embeds"]`` (B, S, D) patch embeddings, a cls token
        prepended and learned positions added, bidirectional, logits
        (B, V) of the cls token.  audio: ``batch["enc_embeds"]`` (B, T, D)
        frame embeddings through the encoder, ``batch["dec_tokens"]``
        (B, S) causally through the decoder, logits (B, S, V).  remat:
        each layer group's activations are recomputed in the backward
        pass (``run_stack``)."""
        cfg = self.cfg
        if cfg.family == "vision":
            x, aux = self._vision_cls(params, batch, remat=remat)
            w = self._top(params, "head")["w"]
            logits = L.matmul_f32(x, w)
            if w.shape[1] != cfg.vocab_size:
                logits = self.par.gather_plain(logits, -1, "model")
        else:
            hidden, aux = self._hidden_for_loss(params, batch, remat=remat)
            logits = self._head(params, hidden)
        return logits, self._aux(aux, logits.device)

    def _vision_cls(self, params, batch, *, remat=False):
        """vision: the final-normed cls rows (B, D) and aux -- a cls token
        prepended to ``batch["embeds"]``, learned positions added, the
        bidirectional stack."""
        cfg = self.cfg
        x = _embeds(batch["embeds"], self.device, self._dtype())
        b, s, d = x.shape
        x = torch.cat([self._top(params, "cls").to(x.dtype).expand(
            b, 1, d), x], dim=1)
        x = x + self._top(params, "pos_embed")[:, :s + 1].to(x.dtype)
        x, _, aux = T.run_stack(params["stack"], x, cfg, causal=False,
                                remat=remat, par=self.par)
        return L.apply_norm(self._top(params, "final_norm"), x,
                            cfg)[:, 0], aux

    @staticmethod
    def _aux(aux, device):
        return torch.as_tensor(aux, dtype=torch.float32, device=device)

    def encode(self, params, enc_embeds, *, remat: bool = False):
        """audio: frame embeddings (B, T, D) plus sinusoidal positions
        through the bidirectional encoder and its final norm."""
        cfg = self.cfg
        x = _embeds(enc_embeds, self.device, self._dtype())
        pos = L.sinusoidal_positions(x.shape[1], cfg.d_model, x.device)
        x, _, _ = T.run_stack(params["enc_stack"], x + pos[None].to(x.dtype),
                              cfg, causal=False, remat=remat, par=self.par,
                              stack="enc_stack")
        return L.apply_norm(self._top(params, "enc_norm"), x, cfg)

    # ------------------------------------------------------------------ loss
    def loss(self, params, batch, *, remat: bool = False):
        """The training loss, as JAX's: the mean cross-entropy of
        ``batch["labels"]`` plus ``0.01 * aux`` (the MoE load-balance
        loss), a 0-d f32 tensor.  vision: labels (B,) against the cls
        logits.  Otherwise labels (B, S), a label < 0 masked out of the
        mean, through the full logits or, when ``_use_chunked_ce``, the
        fused head + cross-entropy ``L.chunked_softmax_xent`` over the
        final hidden states (the logits never materialize).  No host
        sync.

        Under ``par`` (sharded training) the batch is this rank's rows and
        the loss is JAX's global one: the summed nll and the count of
        unmasked labels are taken over the data axes before the division
        (a mean of per-rank means is wrong whenever ranks mask different
        counts), and each rank's MoE aux is its share of the global one.
        This rank's share of the loss is summed over the data axes by
        ``g``: its backward gives the gradient of the share, and the
        shares' gradients are summed over the data axes by the step.
        Over ``model`` > 1 a head cut on its vocabulary (the ViTs' class
        head on its classes) is vocab-parallel (``vocab_parallel_xent``),
        for every family: the audio decoder's cross-attention and the
        vlm's M-RoPE ``embeds`` path run tensor parallel in ``run_stack``."""
        if self.par is not None:
            return self._sharded_loss(params, batch, remat=remat)
        cfg = self.cfg
        labels = _tokens(batch["labels"], self.device)
        if cfg.family == "vision":
            logits, aux = self.forward(params, batch, remat=remat)
            lp = torch.log_softmax(logits, dim=-1)
            nll = -torch.gather(lp, -1, labels[:, None])
            return nll.mean() + 0.01 * aux
        if self._use_chunked_ce():
            hidden, aux = self._hidden_for_loss(params, batch, remat=remat)
            n = hidden.shape[0] * hidden.shape[1]
            flat = labels.reshape(n)
            nll = L.chunked_softmax_xent(hidden.reshape(n, cfg.d_model),
                                         self._head_weight(params), flat,
                                         cfg)
            mask = (flat >= 0).to(torch.float32)
            loss = (nll * mask).sum() / mask.sum().clamp_min(1.0)
            return loss + 0.01 * self._aux(aux, loss.device)
        logits, aux = self.forward(params, batch, remat=remat)
        mask = (labels >= 0).to(torch.float32)
        lp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(lp, -1, labels.clamp_min(0)[..., None])[..., 0]
        loss = (nll * mask).sum() / mask.sum().clamp_min(1.0)
        return loss + 0.01 * aux

    def _sharded_loss(self, params, batch, *, remat=False):
        cfg, par = self.cfg, self.par
        labels = _tokens(batch["labels"], self.device)
        if cfg.family == "vision":
            hidden, aux = self._vision_cls(params, batch, remat=remat)
            flat = labels
            w = self._top(params, "head")["w"]
        else:
            hidden, aux = self._hidden_for_loss(params, batch, remat=remat)
            n = hidden.shape[0] * hidden.shape[1]
            flat = labels.reshape(n)
            hidden = hidden.reshape(n, cfg.d_model)
            w = self._head_weight(params)
        if w.shape[1] != cfg.vocab_size:
            nll = L.vocab_parallel_xent(hidden, w, flat, cfg, par,
                                        chunked=self._use_chunked_ce())
        elif self._use_chunked_ce():
            nll = L.chunked_softmax_xent(hidden, w, flat, cfg)
        else:
            lp = torch.log_softmax(L.logits_head(
                {"table": w.t()}, None, hidden, cfg), dim=-1)
            nll = -torch.gather(lp, -1, flat.clamp_min(0)[:, None])[:, 0]
        mask = (flat >= 0).to(torch.float32)
        count = par.all_reduce(mask.sum(), par.data_axes)
        share = (nll * mask).sum() / count.clamp_min(1.0) \
            + 0.01 * self._aux(aux, nll.device)
        return par.g(share, par.data_axes)

    def _hidden_for_loss(self, params, batch, *, remat=False):
        """The final-normed hidden states before the head, and aux, of
        the audio decoder or an LM family (the fused-CE path; ``forward``
        applies the head to them)."""
        cfg = self.cfg
        if cfg.family == "audio":
            enc = self.encode(params, batch["enc_embeds"], remat=remat)
            y = self._dec_in(params, batch["dec_tokens"])
            y, _, aux = T.run_stack(params["stack"], y, cfg, causal=True,
                                    enc_out=enc, remat=remat, par=self.par)
            return L.apply_norm(self._top(params, "final_norm"), y, cfg), aux
        x, positions = self._lm_inputs(params, batch)
        hidden, _, aux = self._lm_hidden(params, x, positions=positions,
                                         remat=remat)
        return hidden, aux

    def _dec_in(self, params, tokens):
        """audio: decoder token embeddings plus sinusoidal positions from
        0."""
        y = self._embed(params, tokens)
        pos = L.sinusoidal_positions(y.shape[1], self.cfg.d_model, y.device)
        return y + pos[None].to(y.dtype)

    def _lm_only(self, what):
        if self.cfg.family in ("vision", "audio", "vlm") \
                or self.cfg.mrope_sections:
            raise NotImplementedError(
                f"{what} serves token-LM families (dense/moe/hybrid/ssm), "
                f"not {self.cfg.family} ({self.cfg.name})")

    # --------------------------------------------------------------- serving
    def init_cache(self, batch: int, max_seq: int, enc_len: int = 0):
        return T.make_cache(self.cfg, batch, max_seq, enc_len=enc_len,
                            device=self.device)

    def init_paged_cache(self, batch: int, max_seq: int, *, page_size: int,
                         num_blocks: int, kv_dtype: str = "fp"):
        return T.make_paged_cache(self.cfg, batch, max_seq,
                                  page_size=page_size, num_blocks=num_blocks,
                                  device=self.device, kv_dtype=kv_dtype)

    def prefill(self, params, batch, max_seq: int):
        """Process the prompt into a fresh dense cache; returns
        (logits at the last position (B, 1, V), cache).  LM families take
        ``batch["embeds"]`` and ``batch["positions"]`` as ``forward``
        does.  audio: the
        encoder runs over ``batch["enc_embeds"]``, the decoder over
        ``batch["dec_tokens"]``, and each decoder block's cross-attention
        K/V land in the cache's ``cross_kv`` leaves."""
        cfg = self.cfg
        if cfg.family == "vision":
            raise NotImplementedError(
                f"{cfg.name} is encoder-only: no prefill or decode step")
        if cfg.family == "audio":
            enc = self.encode(params, batch["enc_embeds"])
            y = self._dec_in(params, batch["dec_tokens"])
            cache = self.init_cache(y.shape[0], max_seq,
                                    enc_len=enc.shape[1])
            y, cache, _ = T.run_stack(params["stack"], y, cfg, causal=True,
                                      enc_out=enc, cache=cache,
                                      cache_index=0)
            y = L.apply_norm(params["final_norm"], y[:, -1:], cfg)
            return self._head(params, y), cache
        x, positions = self._lm_inputs(params, batch)
        cache = self.init_cache(x.shape[0], max_seq)
        hidden, cache, _ = self._lm_hidden(params, x, positions=positions,
                                           cache=cache, cache_index=0)
        return self._head(params, hidden[:, -1:]), cache

    def prefill_one(self, params, tokens, length: int, max_seq: int):
        """Batch-1 prefill of a right-padded prompt (1, P) whose true
        length is ``length``; returns (logits at the last valid position
        (1, 1, V), the batch-1 dense cache)."""
        self._lm_only("per-slot prefill")
        x = self._embed(params, tokens)
        cache = self.init_cache(x.shape[0], max_seq)
        hidden, cache, _ = self._lm_hidden(params, x, cache=cache,
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
        (1, S) streams straight into the pool (attention K/V), while mamba
        state runs in a zeroed batch-1 part that lands in row ``slot``.
        ``offset`` counts the warm prefix tokens already in shared pages
        (0 on a cold admission), ``length`` the true suffix length;
        ``block_tables`` (1, NB) maps every logical block for the gather,
        ``write_tables`` (1, NB) only the fresh ones (sentinel elsewhere).  Returns (logits at the last
        valid suffix position (1, 1, V), full_cache written in place)."""
        self._lm_only("per-slot prefill")
        x = self._embed(params, tokens)
        view = T.combine_prefill_parts(
            full_cache, T.make_prefill_part(self.cfg, max_seq,
                                            device=self.device))
        dev = self.device
        hidden, view, _ = self._lm_hidden(
            params, x, cache=view, cache_index=int(offset),
            block_tables=torch.as_tensor(block_tables, device=dev),
            write_tables=torch.as_tensor(write_tables, device=dev))
        last = hidden[:, int(length) - 1:int(length)]
        return self._head(params, last), T.merge_prefill_view(
            full_cache, view, int(slot))

    def decode_step(self, params, cache, tokens, cache_index,
                    block_tables=None, positions=None):
        """One decode step.  tokens (B, S): S = 1 for plain decode, or
        S = K+1 for a speculative-verify window (current token + K drafted
        tokens per slot, scored in one step, at per-slot ``cache_index``).
        ``cache_index`` an int (all rows in lock-step) or a (B,) vector of
        per-slot positions; ``block_tables`` (B, NB) when ``cache`` is
        pool-backed; ``positions`` explicit RoPE positions ((3, B, S) for
        M-RoPE: qwen2-vl's next text position on all three streams), which
        rotate q and k only.  Returns (logits (B, S, V), cache written in
        place).
        audio: lock-step only (an int ``cache_index``), the token's
        sinusoidal position added; cross-attention reads the cached
        ``cross_kv``."""
        cfg = self.cfg
        if cfg.family == "vision":
            raise NotImplementedError(
                f"{cfg.name} is encoder-only: no prefill or decode step")
        x = self._embed(params, tokens)
        if not isinstance(cache_index, int):
            cache_index = torch.as_tensor(cache_index, device=self.device)
            if cache_index.dim() == 0:
                cache_index = int(cache_index)
        if cfg.family == "audio":
            if not isinstance(cache_index, int):
                raise ValueError("audio decode steps run in lock-step: "
                                 "cache_index must be a scalar")
            x = x + L.sinusoidal_position_at(cache_index, cfg.d_model,
                                             x.device).to(x.dtype)
        if block_tables is not None:
            block_tables = torch.as_tensor(block_tables, device=self.device)
        hidden, cache, _ = self._lm_hidden(
            params, x, positions=_positions(positions, self.device),
            cache=cache, cache_index=cache_index, block_tables=block_tables)
        return self._head(params, hidden), cache

    def param_count(self, params) -> int:
        if torch.is_tensor(params):
            return params.numel()
        items = params.values() if isinstance(params, dict) else params
        return sum(self.param_count(p) for p in items)


def build_model(cfg: ModelConfig, device: str = "cuda") -> Model:
    T.check_supported(cfg)
    return Model(cfg, device)
