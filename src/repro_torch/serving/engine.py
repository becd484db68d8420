"""Serving engine of the port: per-slot continuous batching, monolithic and
synchronous, over a dense or a paged KV cache, with int8 paged pools and
prompt-lookup speculative decoding.

The counterpart of the JAX package's ``serving/engine.py`` without plans,
the overlapped runtime, adaptive re-planning and tracing (the constructor
raises on each of them).  The engine owns a
slot-indexed cache for its whole lifetime.  Admission prefills one request
(batch 1) into a free slot: on a dense cache through ``prefill_into_slot``
(flash attention, then a slot scatter), on a paged cache through
``prefill_suffix_paged`` (only the suffix a warm prefix leaves, written
straight into the pool).  Every tick then runs one batched greedy decode
step over all slots at per-slot positions; on a paged cache that step is
the fused RoPE + page-write + attention kernel.  With ``speculate=K`` a
tick whose drafter finds something runs one batched VERIFY step instead:
every slot scores a (K+1)-token window (its current token and up to K
drafted tokens) at its own positions, keeps the longest drafted prefix the
model agrees with, and rolls the rejected tail back.  With
``kv_dtype="int8"`` the paged pools hold int8 rows with per-row f32
scales.  A retiring slot never interrupts the others.

Guarantee (held by ``tests/test_torch_serving.py``): each request's token
stream equals the JAX engine's stream for it and, on fp caches, an
isolated one-shot greedy decode of that request, with or without
speculation.  int8 pools change the numbers the decode sees, so their
streams are held to the JAX engine's int8 streams.

The cache is updated in place: the steps return the same cache object.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.backend import dispatch
from repro_torch.cache import ConcurrentPeakTracker, PagedCacheManager
from repro_torch.models import transformer as T
from repro_torch.models.model import Model


def make_serve_step(model: Model):
    """serve_step(params, cache, tokens, cache_index, block_tables=None) ->
    (next_tokens (B, 1), logits, cache) -- one greedy decode step."""

    def serve_step(params, cache, tokens, cache_index, block_tables=None):
        logits, cache = model.decode_step(params, cache, tokens, cache_index,
                                          block_tables=block_tables)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return nxt[:, None], logits, cache

    return serve_step


def make_verify_step(model: Model):
    """verify_step(params, cache, tokens, cache_index, block_tables=None)
    -> (argmax_tokens (B, K+1), cache) -- one speculative-verify step over
    the (B, K+1) window per slot (current token + K drafted tokens): the
    argmaxes score every window position in one batched step, exactly as
    K+1 sequential greedy decodes would."""

    def verify_step(params, cache, tokens, cache_index, block_tables=None):
        logits, cache = model.decode_step(params, cache, tokens, cache_index,
                                          block_tables=block_tables)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return verify_step


def ngram_draft(ctx, k: int, max_ngram: int = 3) -> List[int]:
    """Model-free prompt-lookup drafting: find the most recent earlier
    occurrence of the context's trailing n-gram (longest n first) and
    propose the up-to-``k`` tokens that followed it.  Returns [] when the
    context never repeats -- the tick then runs plain decode."""
    n_ctx = len(ctx)
    if k <= 0 or n_ctx < 2:
        return []
    for n in range(min(max_ngram, n_ctx - 1), 0, -1):
        tail = ctx[n_ctx - n:]
        for i in range(n_ctx - n - 1, -1, -1):
            if np.array_equal(ctx[i:i + n], tail):
                follow = ctx[i + n:i + n + k]
                if len(follow):
                    return [int(t) for t in follow]
    return []


def make_prefill_slot_step(model: Model, max_seq: int):
    """prefill_slot_step(params, full_cache, tokens, slot, length) ->
    (next_token (1,), full_cache) -- admit ONE request into ONE slot."""

    def prefill_slot_step(params, full_cache, tokens, slot, length):
        logits, full_cache = model.prefill_into_slot(
            params, full_cache, tokens, slot, length, max_seq)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), \
            full_cache

    return prefill_slot_step


def make_prefill_suffix_paged_step(model: Model, max_seq: int):
    """Paged admission: prefill the prompt's unmatched suffix straight into
    the pool.  ``offset`` counts the warm-prefix tokens already in shared
    pages; the tables come from ``PagedCacheManager.admit``."""

    def prefill_suffix_paged(params, full_cache, tokens, slot, offset,
                             length, block_tables, write_tables):
        logits, full_cache = model.prefill_suffix_paged(
            params, full_cache, tokens, slot, offset, length, max_seq,
            block_tables, write_tables)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), \
            full_cache

    return prefill_suffix_paged


@dataclass
class Request:
    uid: int
    prompt: np.ndarray               # (prompt_len,)
    max_new_tokens: int
    eos_token: Optional[int] = None  # retire the slot on this token
    out_tokens: List[int] = field(default_factory=list)
    t_submit: float = 0.0
    t_first: float = 0.0             # wall time of the first output token
    t_done: float = 0.0
    slot: int = -1


@dataclass
class ServingEngine:
    """Continuous batching over a persistent slot-indexed cache.

    prefill_bucket: admitted prompts are right-padded to the next multiple
    of this (exact under causal attention: pad tokens sit after every real
    token and their rows are overwritten before any mask admits them).

    paged: global-attention KV lives in a pool of ``num_blocks`` pages of
    ``page_size`` tokens behind per-slot block tables, with content-hash
    prefix sharing and copy-on-write (``repro_torch.cache``);
    ``num_blocks=0`` sizes the pool to the dense reservation.
    ``prefix_cache`` turns on registry lookups and suffix-only prefill on
    warm prefixes.

    speculate: draft up to K tokens per slot by prompt lookup
    (``ngram_draft``) and verify them in one batched step; greedy verify
    keeps every stream equal to plain decode.  Forced to 0 where a window
    cannot be replayed through the cache (``supports_prefix_compute_reuse``
    false).

    kv_dtype: "int8" stores the paged pools as int8 rows with per-row f32
    scales (needs ``paged=True``); "fp" at the model dtype.

    ``plan``, ``overlap``, ``adapt`` and ``trace`` name the JAX engine's
    features this port does not have yet: anything but their defaults
    raises NotImplementedError.
    """
    model: Model
    params: Any
    slots: int
    max_seq: int
    prefill_bucket: int = 16
    plan: Optional[Any] = None
    paged: bool = False
    page_size: int = 16
    num_blocks: int = 0
    prefix_cache: bool = True
    speculate: int = 0
    overlap: bool = False
    kv_dtype: str = "fp"
    adapt: Optional[Any] = None
    trace: Optional[Any] = None

    def __post_init__(self):
        for name, off in (("plan", self.plan is None),
                          ("overlap", not self.overlap),
                          ("adapt", self.adapt is None),
                          ("trace", not self.trace)):
            if not off:
                raise NotImplementedError(
                    f"ServingEngine({name}=...) is not ported yet: the port "
                    f"serves the monolithic synchronous engine")
        self.cfg = self.model.cfg
        self.device = torch.device(self.model.device)
        self.kernel_path = dispatch.kernel_path(self.device)
        self.serve_step = make_serve_step(self.model)
        self._prefill_slot = make_prefill_slot_step(self.model, self.max_seq)
        self._suffix_reuse = (self.paged and self.prefix_cache
                              and T.supports_prefix_compute_reuse(self.cfg))
        # a verify window replays K+1 positions through the cache: exact
        # only where every mixer is global attention and the FFN dense
        self._spec_k = (self.speculate
                        if (self.speculate > 0
                            and T.supports_prefix_compute_reuse(self.cfg))
                        else 0)
        if self._spec_k:
            self._verify_step = make_verify_step(self.model)
        if self.kv_dtype not in ("fp", "int8"):
            raise ValueError(
                f"kv_dtype={self.kv_dtype!r} must be 'fp' or 'int8'")
        if self.kv_dtype != "fp" and not self.paged:
            raise ValueError(
                "kv_dtype='int8' quantizes paged K/V pools -- pass "
                "paged=True")
        self._pager = None
        if self.paged:
            if self.max_seq % self.page_size:
                raise ValueError(
                    f"paged serving needs max_seq ({self.max_seq}) "
                    f"divisible by page_size ({self.page_size})")
            self._prefill_suffix_paged = make_prefill_suffix_paged_step(
                self.model, self.max_seq)
            total = (self.num_blocks
                     or self.slots * (self.max_seq // self.page_size))
            self._pager = PagedCacheManager(
                self.slots, self.max_seq, self.page_size, total,
                prefix_cache=self.prefix_cache, kv_dtype=self.kv_dtype,
                kv_capacity_ratio=T.paged_kv_capacity_ratio(
                    self.cfg, self.kv_dtype))
            self._cache = self.model.init_paged_cache(
                self.slots, self.max_seq, page_size=self.page_size,
                num_blocks=total, kv_dtype=self.kv_dtype)
        else:
            self._cache = self.model.init_cache(self.slots, self.max_seq)
        self._pos = np.zeros((self.slots,), np.int32)    # tokens in cache
        self._cur = np.zeros((self.slots, 1), np.int32)  # next input token
        self._slot_req: List[Optional[Request]] = [None] * self.slots
        self.queue: List[Request] = []
        self.done: List[Request] = []
        self._peak_tracker = ConcurrentPeakTracker()
        if self._pager is not None:
            self._peak_tracker.attach(self._pager.pool)
        self.reset_stats()

    # -- public API --------------------------------------------------------
    def submit(self, req: Request):
        if len(req.prompt) >= self.max_seq:
            raise ValueError(
                f"prompt of {len(req.prompt)} tokens cannot fit a "
                f"max_seq={self.max_seq} slot cache")
        req.t_submit = time.perf_counter()
        self.queue.append(req)

    @property
    def active(self) -> int:
        return sum(r is not None for r in self._slot_req)

    def tick(self) -> bool:
        """Admit whatever fits, then run one batched decode step.  Returns
        True while there is work in flight.  Host wall-clock per phase
        accrues in ``phase_time`` (prefill compute launched inside
        admission is credited to "prefill")."""
        t_enter = time.perf_counter()
        if self._t_tick_end is not None:
            self.phase_time["idle"] += t_enter - self._t_tick_end
        t0 = time.perf_counter()
        self._prefill_window = 0.0
        self._admit()
        t1 = time.perf_counter()
        self.phase_time["admission"] += (t1 - t0) - self._prefill_window
        self.phase_time["prefill"] += self._prefill_window
        if self.active:
            self._decode_once()
            self.phase_time["decode"] += time.perf_counter() - t1
        self.ticks += 1
        self._t_tick_end = time.perf_counter()
        return bool(self.active or self.queue)

    def run(self, max_steps: int = 10_000):
        """Drive ticks until every submitted request retires."""
        steps = 0
        while self.tick() and steps < max_steps:
            steps += 1
        return self.done

    def reset_stats(self):
        """Zero the counters so stats() covers only the window after this
        call (active slots and their blocks are untouched)."""
        self.done = []
        self.decode_steps = 0
        self.decode_tokens = 0
        self._occupied_step_sum = 0
        self._decode_slot_steps = 0
        self.prefill_batch_sizes: List[int] = []
        self.prefill_token_counts: List[int] = []
        self.ticks = 0
        self.spec_steps = 0               # decode ticks that ran a verify
        self.spec_proposed = 0            # drafted tokens offered to verify
        self.spec_accepted = 0            # drafted tokens accepted
        self.phase_time = {"admission": 0.0, "prefill": 0.0, "decode": 0.0,
                           "idle": 0.0, "host_sync": 0.0}
        self._prefill_window = 0.0
        self._t_window = time.perf_counter()
        self._t_tick_end = None
        self._peak_tracker.reset()
        if self._pager is not None:
            p = self._pager.pool
            p.prefix_queries = p.prefix_hits = 0
            p.cow_copies = p.evictions = 0
            p.peak_in_use = p.blocks_in_use
            p.prefill_admissions = p.prefill_compute_hits = 0
            p.reused_prefill_tokens = p.suffix_prefill_tokens = 0

    def cache_stats(self) -> Dict[str, Any]:
        """Live vs reserved tokens and, on a paged engine, the block pool:
        occupancy, prefix reuse, copy-on-writes, effective-slots gain."""
        live = int(sum(int(self._pos[s]) for s in range(self.slots)
                       if self._slot_req[s] is not None))
        reserved = self.slots * self.max_seq
        out: Dict[str, Any] = {
            "layout": "paged" if self.paged else "dense",
            "live_tokens": live,
            "reserved_tokens": reserved,
            "utilization": live / reserved if reserved else 0.0,
        }
        if self._pager is not None:
            agg = dict(self._pager.stats())
            agg["page_size"] = self.page_size
            agg["reuse_hit_rate"] = (agg["prefix_hits"]
                                     / max(agg["prefix_queries"], 1))
            agg["prefix_cache"] = self.prefix_cache
            agg["prefill_hit_rate"] = (agg["prefill_compute_hits"]
                                       / max(agg["prefill_admissions"], 1))
            agg["peak_blocks_in_use"] = self._peak_tracker.peak
            dense_blocks = self.slots * (self.max_seq // self.page_size)
            agg["effective_slots_gain"] = (
                dense_blocks / max(agg["peak_blocks_in_use"], 1))
            out.update(agg)
        return out

    def stats(self) -> Dict[str, Any]:
        """Serving-side latency/throughput numbers."""
        reqs = self.done
        gen = sum(len(r.out_tokens) for r in reqs)
        if reqs:
            t0 = min(max(r.t_submit, self._t_window) for r in reqs)
            wall = max(r.t_done for r in reqs) - t0
        else:
            wall = 0.0
        cap = max(self.decode_steps * self.slots, 1)
        return {
            "kernel_path": self.kernel_path,
            "requests": len(reqs),
            "gen_tokens": gen,
            "decode_steps": self.decode_steps,
            "decode_tokens": self.decode_tokens,
            # per-slot tokens per decode step: exactly 1.0 for plain
            # decode, > 1 when speculation accepts drafted tokens
            "tokens_per_step": (self.decode_tokens
                                / max(self._decode_slot_steps, 1)),
            "spec_steps": self.spec_steps,
            "spec_proposed": self.spec_proposed,
            "spec_accepted": self.spec_accepted,
            "acceptance_rate": (self.spec_accepted
                                / max(self.spec_proposed, 1)),
            "spec_acceptance_rate": (self.spec_accepted
                                     / max(self.spec_proposed, 1)),
            "slot_occupancy": self._occupied_step_sum / cap,
            "throughput_tok_s": gen / wall if wall > 0 else 0.0,
            "ttft_s": [r.t_first - r.t_submit for r in reqs],
            "latency_s": [r.t_done - r.t_submit for r in reqs],
            "ticks": self.ticks,
            "phase_time_s": dict(self.phase_time),
            "cache": self.cache_stats(),
        }

    # -- internals ---------------------------------------------------------
    def _sync(self, x) -> np.ndarray:
        """Copy a device value to the host, charging the wait to the
        ``host_sync`` bucket (an overlay of whichever phase is open)."""
        t0 = time.perf_counter()
        arr = x.cpu().numpy()
        self.phase_time["host_sync"] += time.perf_counter() - t0
        return arr

    def _padded_len(self, n: int) -> int:
        b = max(self.prefill_bucket, 1)
        return min(-(-n // b) * b, self.max_seq - 1)

    def _free_slots(self):
        return [s for s in range(self.slots) if self._slot_req[s] is None]

    def _admit(self):
        while self.queue:
            free = self._free_slots()
            if not free:
                return
            if not self._admit_one(self.queue[0], free[0]):
                return    # head-of-line waits for pool blocks (stays FIFO)
            self.queue.pop(0)

    def _admit_one(self, req: Request, slot: int) -> bool:
        """Prefill ONE request into ONE free slot.  Paged admission is
        suffix-only: the pager reports how many prefix tokens already sit
        in warm blocks and only the rest is prefilled.  Returns False when
        the pool cannot supply the prompt's blocks yet."""
        plen = len(req.prompt)
        if self._pager is not None:
            # speculation headroom: a verify window may write K positions
            # past the plain-decode frontier before rolling back
            ap = self._pager.admit(slot, req.prompt,
                                   req.max_new_tokens + self._spec_k,
                                   reuse_compute=self._suffix_reuse)
            if ap is None:
                return False
            reused = ap.reused_tokens
            suffix = req.prompt[reused:]
            slen = len(suffix)
            toks = np.zeros((1, self._padded_len(slen)), np.int32)
            toks[0, :slen] = suffix
            t0 = time.perf_counter()
            nxt, self._cache = self._prefill_suffix_paged(
                self.params, self._cache, toks, slot, reused, slen,
                ap.block_table[None], ap.write_table[None])
            self._pager.commit(slot)      # pages landed: publish for reuse
            tok = int(self._sync(nxt)[0])
            self._prefill_window += time.perf_counter() - t0
        else:
            slen = plen
            toks = np.zeros((1, self._padded_len(plen)), np.int32)
            toks[0, :plen] = req.prompt
            t0 = time.perf_counter()
            nxt, self._cache = self._prefill_slot(
                self.params, self._cache, toks, slot, plen)
            tok = int(self._sync(nxt)[0])
            self._prefill_window += time.perf_counter() - t0
        self.prefill_batch_sizes.append(1)
        self.prefill_token_counts.append(slen)
        self._activate(req, slot, tok)
        return True

    def _activate(self, req: Request, slot: int, first_token: int):
        req.slot = slot
        req.t_first = time.perf_counter()
        req.out_tokens.append(first_token)
        self._slot_req[slot] = req
        self._pos[slot] = len(req.prompt)
        self._cur[slot, 0] = first_token
        self._maybe_retire(slot, req.t_first)

    def _prepare_paged_writes(self):
        """Before a decode step: make every active slot's target block
        writable -- allocate at page boundaries, copy-on-write shared or
        registered blocks (the device page copy runs here)."""
        for slot in range(self.slots):
            if self._slot_req[slot] is None:
                continue
            cow = self._pager.prepare_decode(slot, int(self._pos[slot]))
            if cow is not None:
                T.copy_cache_pages(self._cache, *cow)

    def _decode_once(self):
        """One batched decode step at per-slot positions.  Idle slots ride
        along at fixed shape: on a paged cache their tables are all
        sentinel, so their writes land in the sink page.  With
        speculation on, a tick whose drafter finds something runs a
        batched verify step instead."""
        act = self.active
        drafts = self._draft_all() if self._spec_k else None
        if drafts is not None:
            self._decode_verify(drafts)
        else:
            bt = None
            if self._pager is not None:
                self._prepare_paged_writes()
                bt = torch.from_numpy(self._pager.table_matrix()).to(
                    self.device)
            nxt, _, self._cache = self.serve_step(
                self.params, self._cache,
                torch.from_numpy(self._cur).to(self.device),
                torch.from_numpy(self._pos).to(self.device), bt)
            arr = self._sync(nxt)
            self._collect_decoded(arr, time.perf_counter())
        self.decode_steps += 1
        self._decode_slot_steps += act
        self._occupied_step_sum += self.active

    # -- speculative decode ------------------------------------------------
    def _draft_all(self):
        """Prompt-lookup drafts for every active slot, or None when this
        tick should run plain decode instead (no slot drafted anything,
        or some active slot's window would run past the slot cache).  A
        slot's draft is clamped so accepted tokens never overshoot its
        remaining budget."""
        k = self._spec_k
        drafts: Dict[int, List[int]] = {}
        any_draft = False
        for slot in range(self.slots):
            req = self._slot_req[slot]
            if req is None:
                continue
            if int(self._pos[slot]) + k > self.max_seq - 2:
                # the window would write past the last position the gold
                # decode ever writes (max_seq - 2): plain-decode this tick
                return None
            # accepting all K drafts emits K+1 tokens: cap at the budget
            budget = min(k, req.max_new_tokens - len(req.out_tokens) - 1)
            ctx = np.concatenate([req.prompt,
                                  np.asarray(req.out_tokens, np.int32)])
            d = ngram_draft(ctx, budget)
            drafts[slot] = d
            any_draft = any_draft or bool(d)
        return drafts if any_draft else None

    def _prepare_verify_writes(self, sw: int):
        """Before a verify step: make every window position's block
        writable for every active slot (boundary blocks allocate; a shared
        or registered block copies-on-write, which can happen only at the
        first window position -- the rest of the window grows fresh
        blocks)."""
        for slot in range(self.slots):
            if self._slot_req[slot] is None:
                continue
            pos = int(self._pos[slot])
            for j in range(sw):
                cow = self._pager.prepare_decode(slot, pos + j)
                if cow is not None:
                    T.copy_cache_pages(self._cache, *cow)

    def _decode_verify(self, drafts: Dict[int, List[int]]):
        """One speculative tick: write and score each slot's (K+1)-token
        window in one batched step, accept the longest prefix of drafts
        the model agrees with (greedy verify), roll the rejected tail
        back, and continue from the last accepted token.  Slots that
        drafted nothing degenerate to plain decode (their window is the
        current token plus ignored padding)."""
        sw = self._spec_k + 1
        window = np.zeros((self.slots, sw), np.int32)
        window[:, 0] = self._cur[:, 0]
        for slot, d in drafts.items():
            if d:
                window[slot, 1:1 + len(d)] = d
        bt = None
        if self._pager is not None:
            self._prepare_verify_writes(sw)
            bt = torch.from_numpy(self._pager.table_matrix()).to(self.device)
        outs, self._cache = self._verify_step(
            self.params, self._cache, torch.from_numpy(window).to(self.device),
            torch.from_numpy(self._pos).to(self.device), bt)
        arr = self._sync(outs)
        self._collect_verified(window, arr, drafts, time.perf_counter())
        self.spec_steps += 1

    def _collect_verified(self, window, outs, drafts, now: float):
        """Greedy acceptance per slot: position j's argmax is what a
        sequential decode would emit after consuming window[0..j], so the
        emitted prefix extends exactly while each argmax equals the next
        drafted token (and is not EOS)."""
        for slot in range(self.slots):
            req = self._slot_req[slot]
            if req is None:
                continue
            d = drafts.get(slot, [])
            pos = int(self._pos[slot])
            row = outs[slot]
            emitted: List[int] = []
            j = 0
            while True:
                tok = int(row[j])
                emitted.append(tok)
                if req.eos_token is not None and tok == req.eos_token:
                    break
                if j < len(d) and int(window[slot, j + 1]) == tok:
                    j += 1
                else:
                    break
            m = len(emitted)
            if self._pager is not None:
                # the step wrote the window's K/V at pos..pos+K: keep the
                # accepted inputs' chain, then roll the rejected tail back
                for i in range(m):
                    self._pager.note_written(slot, int(window[slot, i]),
                                             pos + i)
                self._pager.rollback(slot, pos + m)
            self._pos[slot] = pos + m    # dense caches just rewind here
            req.out_tokens.extend(emitted)
            self._cur[slot, 0] = emitted[-1]
            self.decode_tokens += m
            self.spec_proposed += len(d)
            self.spec_accepted += m - 1
            self._maybe_retire(slot, now)

    def _collect_decoded(self, arr, now: float):
        for slot in range(self.slots):
            req = self._slot_req[slot]
            if req is None:
                continue
            if self._pager is not None:
                # the step wrote this slot's INPUT token's K/V at _pos
                self._pager.note_written(slot, int(self._cur[slot, 0]),
                                         int(self._pos[slot]))
            self._pos[slot] += 1
            tok = int(arr[slot, 0])
            req.out_tokens.append(tok)
            self._cur[slot, 0] = tok
            self.decode_tokens += 1
            self._maybe_retire(slot, now)

    def _maybe_retire(self, slot: int, now: float):
        """Slot-level retirement: EOS, token budget, or a full slot cache.
        Paged engines release the slot's blocks (registered ones park in
        the pool's LRU for prefix reuse)."""
        req = self._slot_req[slot]
        if (len(req.out_tokens) >= req.max_new_tokens
                or (req.eos_token is not None
                    and req.out_tokens[-1] == req.eos_token)
                or int(self._pos[slot]) >= self.max_seq - 1):
            req.t_done = now
            self.done.append(req)
            self._slot_req[slot] = None
            if self._pager is not None:
                self._pager.release_slot(slot)
