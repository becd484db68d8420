"""Serving engine of the port: per-slot continuous batching over a dense or
a paged KV cache, with int8 paged pools, prompt-lookup speculative
decoding, plan-driven serving, an overlapped decode runtime and tracing.

It serves the dense GQA decoders and the attention + mamba hybrid (jamba
with dense FFNs): a hybrid's mamba state is dense per slot beside the
paged attention pools, its prompts prefill at their exact length, and a
warm prefix shares its blocks' memory but is prefilled in full
(speculation is off for it, as in JAX).

The counterpart of the JAX package's ``serving/engine.py``.  The engine
owns a slot-indexed cache for its whole lifetime.  Admission prefills one
request (batch 1) into a free slot: on a dense cache through
``prefill_into_slot`` (flash attention, then a slot scatter), on a paged
cache through ``prefill_suffix_paged`` (only the suffix a warm prefix
leaves, written straight into the pool).  Every tick then runs one batched greedy decode
step over all slots at per-slot positions; on a paged cache that step is
the fused RoPE + page-write + attention kernel.  With ``speculate=K`` a
tick whose drafter finds something runs one batched VERIFY step instead:
every slot scores a (K+1)-token window (its current token and up to K
drafted tokens) at its own positions, keeps the longest drafted prefix the
model agrees with, and rolls the rejected tail back.  With
``kv_dtype="int8"`` the paged pools hold int8 rows with per-row f32
scales.  A retiring slot never interrupts the others.

**Plan-driven mode** (``plan=lower_serving(execution_plan, slots,
chunk)``, ``repro_torch.plan.serving``): admission becomes a chunked
prefill -- the prompt is cut into ``chunk``-token pieces that stream
through the plan's stage slices, one stage-step a tick, between decode
steps -- and the plan's spatial width becomes N decode replicas, each
owning a contiguous range of the slots and walking the stage slices per
decode step.  On one card the stages and replicas share the device,
time-multiplexed.  The replicas' caches are views of the engine's one
cache (``T.slice_cache_slots``: dense leaves sliced on the slot axis,
the paged pools whole), and the pager is engine-wide, so every write of a
replica's step lands in ``self._cache`` and blocks are shared across
replicas.

**Overlapped runtime** (``overlap=True``, monolithic or plan-driven):
decode step N+1 is dispatched before step N's tokens are read back.  Its
input tokens stay on the device (``_cur_dev``, a buffer every step copies
its output into); positions and block tables go through fresh pinned host
buffers with ``non_blocking=True`` copies (a copy from pageable memory
would wait for step N); and each step's output tokens are copied into
pinned host memory right after it, with a CUDA event recorded after the
copies, on which the drain waits.  Every cache write stays on the one
current stream, so stream order serializes them.  A slot retires one tick
later than in sync mode; the token streams are the same.  Speculation
needs its drafts on the host every tick, so an effective ``speculate``
runs sync.

**Adaptive mode** (``adapt=AdaptiveConfig(...)``,
``repro_torch.serving.adaptive``): a re-plan controller watches the
rolling-window arrival rate, queue depth and TTFT/TPOT against SLO targets
and calls ``replan()`` when another design point (the monolithic engine or
a ``ServingPlan``) prices lower, without dropping a request.  The replica
caches are views of the one cache and the pager is engine-wide, so a swap
re-slices views: on a paged all-global-attention model it moves no K/V (a
slot's state is its block-table row), and only dense rows (a hybrid's
mamba state, every leaf of a dense cache) are copied when a slot moves.

**Observability**: always on, a ``MetricsRegistry`` (TTFT/TPOT
histograms, request and token counters, observed at retirement) and the
per-stage / per-replica utilization accumulators (``stats()
["utilization"]``); with ``trace=TraceConfig()`` (or True) a
ring-buffered ``Tracer`` records request-lifecycle and per-stage /
per-replica spans (``write_trace`` exports Perfetto JSON).  With
``trace=None`` no record is allocated.

Guarantee (held by ``tests/test_torch_serving.py`` and, for plans,
``tests/test_torch_plan_serving.py``, for overlap
``tests/test_torch_overlap.py``): each request's token stream equals
the JAX engine's stream for it and, on fp caches, an isolated one-shot
greedy decode of that request, with or without speculation, overlap or a
plan, and across any sequence of live re-plans
(``tests/test_torch_adaptive.py``).  int8 pools change the numbers the
decode sees, so their streams are held to the JAX engine's int8 streams.

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
from repro_torch.obs import (TPOT_BUCKETS, TTFT_BUCKETS, MetricsRegistry,
                             TraceConfig, Tracer, TrafficSnapshot,
                             fold_engine_metrics)
from repro_torch.obs import write_trace as _write_trace
from repro_torch.plan.serving import PlanRuntime, PrefillPipeline
from repro_torch.serving.adaptive import ReplanController


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


@dataclass(eq=False)
class _Inflight:
    """One dispatched-but-undrained decode step (overlap mode).

    ``arrs`` holds each decode batch's output tokens as they land on the
    host (pinned buffers filled by copies enqueued right after the step;
    on a CPU engine the output tensors themselves), and ``event`` the CUDA
    event recorded after those copies (None on the CPU).
    ``in_toks[slot]`` is the token whose K/V the step wrote -- host-known
    at dispatch only right after activation (the prefill's first token);
    otherwise it is the PREVIOUS step's output and is filled in when that
    step drains (always before this record's own drain)."""
    arrs: List[Any]                   # [(host tokens, a, b)]
    event: Any
    entries: List[Any]                # [(slot, req, pos_written)]
    in_toks: Dict[int, Optional[int]]


@dataclass
class ServingEngine:
    """Continuous batching over a persistent slot-indexed cache.

    prefill_bucket: admitted prompts are right-padded to the next multiple
    of this (exact under causal attention: pad tokens sit after every real
    token and their rows are overwritten before any mask admits them).
    Forced to 1 (exact-length prefill) when any mixer is recurrent, and in
    plan mode (chunks run at exact lengths).

    plan: a ``repro_torch.plan.ServingPlan`` (``lower_serving``) -- run
    plan-driven: chunked prefill through the plan's stages and
    slot-partitioned decode replicas.  Its ``slots`` must equal the
    engine's.

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

    overlap: dispatch decode step N+1 before reading step N's tokens back
    (one-step-delayed drain; see the module docstring).  An effective
    ``speculate`` forces sync.

    trace: a ``repro_torch.obs.TraceConfig`` (or True for defaults):
    record spans into a ring-buffered Tracer (``write_trace``).  None: no
    record is allocated.

    adapt: a ``repro_torch.serving.AdaptiveConfig``: traffic-adaptive
    re-planning between its candidate design points (``replan``).
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
        self.cfg = self.model.cfg
        self.device = torch.device(self.model.device)
        self.kernel_path = dispatch.kernel_path(self.device)
        self.serve_step = make_serve_step(self.model)
        self._prefill_slot = make_prefill_slot_step(self.model, self.max_seq)
        if any(not b.mixer.startswith("attn") or b.ffn == "moe"
               for b in self.cfg.block_pattern):
            # pad tokens are only exactly neutral under causal attention +
            # dense FFN: a recurrent mixer folds them into its state, and
            # MoE routing lets them compete for expert capacity.  Prefill
            # those families at the exact prompt length.
            self.prefill_bucket = 1
        # the smallest sliding-window ring among the mixers: a padded
        # prompt never spills past it (the ring's tail write would keep
        # pad K/V and evict real tokens the gold decode still attends)
        self._ring_min = min(
            (min(self.max_seq, self.cfg.window_size)
             for b in self.cfg.block_pattern if b.mixer == "attn_local"),
            default=0)
        if self.paged and not T.has_paged_layers(self.cfg):
            # nothing to page: every mixer keeps dense state (SSM) or a
            # dense ring (local windows), so the engine runs dense
            self.paged = False
        # compute reuse skips a warm prefix's prefill; a hybrid keeps only
        # memory sharing (its recurrent state has no per-position cache to
        # resume from)
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
            # ONE manager for the whole engine, monolithic or plan mode:
            # rows are global slot ids and every replica's view fronts
            # the same pool, so prefix blocks are shared engine-wide
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
        self._rt = self._pf = self._caches = None
        self._rt_cache = {}              # ServingPlan -> PlanRuntime: a
        #                                  re-plan back to a seen point
        #                                  reuses its runtime
        if self.plan is not None:
            if self.plan.slots != self.slots:
                raise ValueError(
                    f"ServingPlan was lowered for {self.plan.slots} slots "
                    f"but the engine has {self.slots}; re-lower via "
                    f"lower_serving(plan, slots={self.slots})")
            self._rt = self._runtime_for(self.plan)
            self._pf = PrefillPipeline(self._rt, self.params)
            # one cache VIEW per decode replica over self._cache (its
            # slot range; the paged pools whole)
            self._caches = self._replica_views(self.plan, self._cache)
            self.prefill_bucket = 1       # chunks run at exact lengths
        self._reserved = set()           # slots mid-(chunked)-prefill
        self._pos = np.zeros((self.slots,), np.int32)    # tokens in cache
        self._cur = np.zeros((self.slots, 1), np.int32)  # next input token
        # overlap runtime state (an effective speculate forces sync)
        self._overlap = bool(self.overlap) and self._spec_k == 0
        self._inflight: List[_Inflight] = []   # dispatched, undrained steps
        self._cur_dev = None             # device-side token chain: every
        #                                  step copies its output here, so
        #                                  step N+1's inputs never
        #                                  round-trip through the host
        self._cur_known = np.ones((self.slots,), bool)  # _cur[s] current?
        self._slot_req: List[Optional[Request]] = [None] * self.slots
        self.queue: List[Request] = []
        self.done: List[Request] = []
        self._arrival_log = []           # (t_submit, prompt_len, max_new)
        self._peak_tracker = ConcurrentPeakTracker()
        if self._pager is not None:
            self._peak_tracker.attach(self._pager.pool)
        # always on: the request metrics (observed at retirement) and the
        # utilization accumulators (integer adds per decode dispatch and
        # pipeline step).  The Tracer is opt-in: every emission site is
        # guarded on self._tr, so trace=None allocates no record.
        self.metrics = MetricsRegistry()
        self._h_ttft = self.metrics.histogram(
            "repro_ttft_seconds", TTFT_BUCKETS,
            help="time to first token per retired request")
        self._h_tpot = self.metrics.histogram(
            "repro_tpot_seconds", TPOT_BUCKETS,
            help="time per output token per retired request")
        self._c_requests = self.metrics.counter(
            "repro_requests_total", help="requests retired")
        self._c_gen = self.metrics.counter(
            "repro_tokens_generated_total", help="tokens generated")
        self._tr = None
        if self.trace:
            self.enable_trace(self.trace)
        self.reset_stats()
        self._ctl = None
        if self.adapt is not None:
            self._ctl = ReplanController(self.adapt)
            self._ctl.validate(self)

    # -- public API --------------------------------------------------------
    def submit(self, req: Request):
        if len(req.prompt) >= self.max_seq:
            raise ValueError(
                f"prompt of {len(req.prompt)} tokens cannot fit a "
                f"max_seq={self.max_seq} slot cache")
        req.t_submit = time.perf_counter()
        self.queue.append(req)
        self._arrival_log.append((req.t_submit, len(req.prompt),
                                  req.max_new_tokens))
        if len(self._arrival_log) > 4 * self.slots + 256:
            del self._arrival_log[:len(self._arrival_log) // 2]
        if self._tr is not None:
            self._tr.instant("requests", "submit", t=req.t_submit, args={
                "uid": req.uid, "prompt_tokens": len(req.prompt),
                "max_new": req.max_new_tokens})

    def enable_trace(self, cfg: Any = True):
        """Attach a fresh ring-buffered ``Tracer`` to the engine and its
        prefill pipeline.  ``cfg`` is a ``TraceConfig`` (or True for
        defaults).  May be called mid-serve.  Returns the tracer."""
        if cfg is True or cfg is None:
            cfg = TraceConfig()
        self._tr = Tracer(cfg.capacity)
        if self._pf is not None:
            self._pf.tracer = self._tr
        return self._tr

    @property
    def active(self) -> int:
        return sum(r is not None for r in self._slot_req)

    def tick(self) -> bool:
        """Admit whatever fits, advance the chunked prefills in flight by
        one stage-step (plan mode), then run one batched decode step (per
        replica in plan mode).  Returns True while there is work in
        flight.  Host wall-clock per phase accrues in ``phase_time``
        (prefill compute launched inside admission, and the pipeline's
        stage-steps, are credited to "prefill").

        Overlap mode reorders the decode phase: this tick's step is
        dispatched first (its input tokens are the previous step's
        output, still on the device), and only then is the previous
        step's result read back, so the device computes step N while the
        host drains step N-1 and runs the next tick's bookkeeping.

        With ``adapt`` the re-plan controller is consulted first, its time
        (and any swap's) charged to ``phase_time["replan"]``."""
        t_enter = time.perf_counter()
        if self._t_tick_end is not None:
            self.phase_time["idle"] += t_enter - self._t_tick_end
        tr = self._tr
        if tr is not None:
            tr.counter("tick", "engine", {"queue": len(self.queue),
                                          "active": self.active}, t=t_enter)
        if self._ctl is not None and not self._ctl.paused:
            tc = time.perf_counter()
            decision = self._ctl.observe(self)  # None: keep; (plan,): swap
            self.phase_time["replan"] += time.perf_counter() - tc
            if tr is not None and self._ctl.last_scores is not None:
                tr.instant("tick", "replan_decision", args={
                    "scores": self._ctl.last_scores,
                    "decision": ("keep" if decision is None else
                                 (decision[0].label
                                  if decision[0] is not None else "mono"))})
            if decision is not None:
                self.replan(decision[0])
        t0 = time.perf_counter()
        self._prefill_window = 0.0
        q0 = len(self.queue)
        self._admit()
        t1 = time.perf_counter()
        self.phase_time["admission"] += (t1 - t0) - self._prefill_window
        self.phase_time["prefill"] += self._prefill_window
        if tr is not None and q0:
            tr.span("tick", "admission", t0, t1, args={
                "queued": q0, "admitted": q0 - len(self.queue),
                "plan": self.plan.label if self.plan is not None else "mono"})
        if self._pf is not None and self._pf.busy:
            # after a re-plan to monolithic the drained items' paged
            # stage-steps go through the whole cache (item.replica is 0)
            if self.plan is not None:
                clist = self._caches
            else:
                clist = [self._cache] if self.paged else None
            finished = self._pf.step(caches=clist,
                                     on_chunk=self._chunk_committed)
            self._pipeline_ticks += 1
            for s in self._pf.last_stages_run:
                self._stage_busy[s] = self._stage_busy.get(s, 0) + 1
            for item in finished:
                self._finish_prefill(item)
            self.phase_time["prefill"] += time.perf_counter() - t1
        if self._pf is not None and self.plan is None and not self._pf.busy:
            self._pf = None       # the old pipeline drained after a re-plan
        if self.active or self._inflight:
            t2 = time.perf_counter()
            dispatched = False
            if self.active:
                if self._overlap:
                    self._dispatch_decode()
                    dispatched = True
                else:
                    self._decode_once()
            # one-step-delayed drain: the newest dispatch stays in flight
            # while its predecessor's tokens come back; once nothing new
            # dispatches, drain everything so the last slots retire
            while len(self._inflight) > (1 if dispatched else 0):
                self._drain_one()
            self.phase_time["decode"] += time.perf_counter() - t2
        self.ticks += 1
        self._t_tick_end = time.perf_counter()
        return bool(self.active or self.queue or self._inflight
                    or (self._pf is not None and self._pf.busy))

    def run(self, max_steps: int = 10_000):
        """Drive ticks until every submitted request retires."""
        steps = 0
        while self.tick() and steps < max_steps:
            steps += 1
        return self.done

    def replan(self, plan, *, rebalance: bool = True):
        """Swap the engine onto another ``ServingPlan`` (None: monolithic)
        without dropping a request -- the online Pareto move.

          * paged K/V never moves: every replica's view fronts the one
            pool and the pager's rows are global slot ids, so re-binding
            decode to a new replica partition re-slices views;
            ``migration_copies`` stays 0 on an all-global-attention model;
          * dense slot rows (a hybrid's mamba state, every leaf of a dense
            cache) are copied only when ``_rebalance_slots`` moves a slot;
          * chunked prefills in flight drain and rebind: their remaining
            chunks finish on the runtime they were admitted under, only
            their replica routing is remapped; decode binds the new plan
            at once;
          * overlap mode: the undrained steps land first.

        The stats window continues across the swap; its wall time accrues
        in ``phase_time["replan"]``.  ``replan(self.plan)`` is pure
        cross-replica work stealing (``rebalance=False`` suppresses it)."""
        t0 = time.perf_counter()
        old_label = self.plan.label if self.plan is not None else "mono"
        if plan is not None and plan.slots != self.slots:
            raise ValueError(
                f"ServingPlan was lowered for {plan.slots} slots "
                f"but the engine has {self.slots}; re-lower via "
                f"lower_serving(plan, slots={self.slots})")
        if plan == self.plan:
            if rebalance and self.plan is not None:
                self._drain_inflight()
                self._rebalance_slots()
                if self._tr is not None:
                    self._tr.span("tick", "rebalance", t0, args={
                        "plan": old_label, "migrations": self.migrations})
            self.phase_time["replan"] += time.perf_counter() - t0
            return
        # 1. land everything in flight on the old binding
        self._drain_inflight()
        # 2. drain and rebind the prefill pipeline: the items in flight
        #    keep their admission runtime (item.rt), only their replica
        #    routing is remapped to where their slot lives now
        items = list(self._pf.items) if self._pf is not None else []
        if plan is not None:
            self._rt = self._runtime_for(plan)
            pf = PrefillPipeline(self._rt, self.params, tracer=self._tr)
            pf.adopt(items)
            self._pf = pf
        else:
            self._rt = None
            if not items:
                self._pf = None
            # else: the old pipeline lives on only to drain its items
        for it in items:
            it.replica, it.local_slot = ((0, it.slot) if plan is None
                                         else plan.replica_of_slot(it.slot))
        # 3. re-bind decode: views of the one cache for the new partition
        self.plan = plan
        self._caches = (self._replica_views(plan, self._cache)
                        if plan is not None else None)
        # 4. the pool and its manager survive as they are: re-attach the
        #    pool to the engine-lifetime peak tracker (idempotent)
        if self._pager is not None:
            self._peak_tracker.attach(self._pager.pool)
        # 5. spread the surviving decode slots over the new replicas
        if rebalance and plan is not None:
            self._rebalance_slots()
        self.replans += 1
        self.phase_time["replan"] += time.perf_counter() - t0
        if self._tr is not None:
            self._tr.span("tick", "replan", t0, args={
                "from": old_label,
                "to": plan.label if plan is not None else "mono",
                "migrations": self.migrations,
                "migration_copies": self.migration_copies})

    def warm_replans(self):
        """Exercise every adaptive candidate once (its measured profile,
        its runtime and a short request through it), then restore the
        initial binding.  Call before ``reset_stats()`` in a benchmark."""
        if self._ctl is None:
            return
        initial = self.plan
        self._ctl.paused = True
        try:
            self._ctl.warm(self)
            uid = -1
            for cand in self._ctl.cfg.plans:
                self.replan(cand, rebalance=False)
                chunk = cand.chunk if cand is not None else 4
                prompt = np.ones((max(2 * chunk, 4),), np.int32)
                self.submit(Request(uid=uid, prompt=prompt,
                                    max_new_tokens=3))
                uid -= 1
                self.run()
            self.replan(initial, rebalance=False)
        finally:
            self._ctl.paused = False

    def _rebalance_slots(self):
        """Cross-replica work stealing: move active decode slots from
        overloaded replicas onto free slots of underloaded ones until no
        replica holds 2 or more slots above another.  Slots mid-prefill
        (reserved) stay put."""
        plan = self.plan
        R = plan.n_replicas
        while True:
            load = [0] * R
            for s in range(self.slots):
                if self._slot_req[s] is not None or s in self._reserved:
                    load[plan.replica_of_slot(s)[0]] += 1
            hi = max(range(R), key=lambda r: load[r])
            lo = min(range(R), key=lambda r: load[r])
            if load[hi] - load[lo] <= 1:
                return
            a, b = plan.replica_range(hi)
            movable = [s for s in range(a, b)
                       if self._slot_req[s] is not None
                       and s not in self._reserved]
            la, lb = plan.replica_range(lo)
            dsts = [s for s in range(la, lb)
                    if self._slot_req[s] is None
                    and s not in self._reserved]
            if not movable or not dsts:
                return        # the surplus is all mid-prefill
            self._migrate_slot(movable[-1], dsts[0])

    def _migrate_slot(self, src: int, dst: int):
        """Move one active decode request between slots (and so
        replicas).  Paged: ``PagedCacheManager.migrate_slot`` hands the
        block-table row over and no K/V moves.  Dense rows (a hybrid's
        mamba state; every leaf of a dense cache) are copied in place
        within the one cache; ``migration_copies`` counts those moves."""
        assert self._slot_req[dst] is None and dst not in self._reserved
        assert src not in self._reserved
        req = self._slot_req[src]
        if self._pager is not None:
            self._pager.migrate_slot(src, dst)
        rs, ls = self.plan.replica_of_slot(src)
        rd, ld = self.plan.replica_of_slot(dst)
        part = T.extract_dense_slot(self._caches[rs], ls)
        if part:
            T.scatter_cache_slot(self._caches[rd], part, ld)
            self.migration_copies += 1
        self._slot_req[dst] = req
        self._slot_req[src] = None
        req.slot = dst
        self._pos[dst] = self._pos[src]
        self._pos[src] = 0
        self._cur[dst] = self._cur[src]
        self._cur_known[dst] = self._cur_known[src]
        self._cur_known[src] = True
        self.migrations += 1

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
        self.prefill_chunk_counts: List[int] = []  # chunks per admission
        self.ticks = 0
        self.spec_steps = 0               # decode ticks that ran a verify
        self.spec_proposed = 0            # drafted tokens offered to verify
        self.spec_accepted = 0            # drafted tokens accepted
        self.replans = 0                  # live plan swaps this window
        self.migrations = 0               # slots moved (work stealing)
        self.migration_copies = 0         # dense row moves those cost (0
        #                                   on a paged all-global-attention
        #                                   model: the zero-copy claim)
        # host wall-clock per phase; "replan" charges controller decisions
        # and swaps; "host_sync" overlays the others: the time the host
        # spent blocked on device readback (what overlap shrinks)
        self.phase_time = {"admission": 0.0, "prefill": 0.0, "decode": 0.0,
                           "replan": 0.0, "idle": 0.0, "host_sync": 0.0}
        self._stage_busy = {}             # stage -> pipeline steps it ran
        self._pipeline_ticks = 0          # ticks the prefill pipeline ran
        self._replica_busy = {}           # replica -> occupied slot-steps
        self._replica_cap = {}            # replica -> dispatched capacity
        self.metrics.reset()
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
            self._pager.migrations = 0

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

    def utilization_stats(self) -> Dict[str, Any]:
        """Windowed pipeline and replica utilization from the always-on
        accumulators (a pure read):

          * ``stage_bubble_frac[s]``: the share of busy-pipeline ticks on
            which prefill stage ``s`` ran no chunk;
          * ``replica_occupancy[r]``: occupied slot-steps over dispatched
            slot-step capacity of decode replica ``r`` (monolithic:
            replica 0 over all slots);
          * ``replica_load_spread``: the max-min occupancy gap;
          * the speculation acceptance and prefix compute-hit rates."""
        pt = self._pipeline_ticks
        n_stages = self.plan.n_stages if self.plan is not None else 0
        if self._stage_busy:
            n_stages = max(n_stages, max(self._stage_busy) + 1)
        bubbles = ({s: 1.0 - self._stage_busy.get(s, 0) / pt
                    for s in range(n_stages)} if pt else {})
        occ = {r: self._replica_busy.get(r, 0) / c
               for r, c in sorted(self._replica_cap.items()) if c}
        spread = (max(occ.values()) - min(occ.values())) if occ else 0.0
        hits = queries = 0
        if self._pager is not None:
            ps = self._pager.stats()
            hits, queries = ps["prefill_compute_hits"], \
                ps["prefill_admissions"]
        return {
            "pipeline_ticks": pt,
            "stage_busy_ticks": dict(sorted(self._stage_busy.items())),
            "stage_bubble_frac": bubbles,
            "replica_occupancy": occ,
            "replica_load_spread": spread,
            "spec_acceptance_rate": (self.spec_accepted
                                     / max(self.spec_proposed, 1)),
            "prefix_hit_rate": hits / max(queries, 1),
        }

    def traffic_snapshot(self, window_s: float = 2.0, *,
                         slo_ttft_s: float = 0.0, slo_tpot_s: float = 0.0,
                         horizon_s: float = 0.0):
        """One typed observation of live traffic (``TrafficSnapshot``), or
        None when the engine is idle: arrivals over the last ``window_s``,
        the queue, the active slots' remaining depth, and whether recent
        requests broke the TTFT/TPOT targets."""
        now = time.perf_counter()
        w = max(window_s, 1e-6)
        recent = [(t, pl, mn) for t, pl, mn in self._arrival_log
                  if t >= now - w]
        lam = len(recent) / w
        avg_prompt = (float(np.mean([pl for _, pl, _ in recent]))
                      if recent else 0.0)
        avg_new = (float(np.mean([mn for _, _, mn in recent]))
                   if recent else 0.0)
        queued_tok = float(sum(len(r.prompt) for r in self.queue))
        rem = [r.max_new_tokens - len(r.out_tokens)
               for r in self._slot_req if r is not None]
        depth = float(np.mean(rem)) if rem else 0.0
        # forecast decode depth for work that has not prefilled yet
        incoming = len(self.queue) + lam * horizon_s
        if incoming > 0 and avg_new > 0:
            depth = max(depth, avg_new)
        if not rem and not self.queue and not recent:
            return None
        violated = False
        if slo_ttft_s > 0:
            if any(r.t_first - r.t_submit > slo_ttft_s
                   for r in self.done[-8:]):
                violated = True
            if self.queue and now - self.queue[0].t_submit > slo_ttft_s:
                violated = True
        if slo_tpot_s > 0:
            for r in self.done[-8:]:
                n = max(len(r.out_tokens) - 1, 1)
                if (r.t_done - r.t_first) / n > slo_tpot_s:
                    violated = True
        return TrafficSnapshot(
            lam=lam, avg_prompt=avg_prompt, avg_new=avg_new,
            queued_tok=queued_tok, depth=depth, queue_len=len(self.queue),
            active=self.active, violated=violated, window_s=w)

    def export_metrics(self):
        """Fold the current ``stats()`` into the ``MetricsRegistry`` as
        gauges (idempotent: gauges are set, never accrued) and return the
        registry, for ``to_prometheus()`` or ``obs.write_metrics``."""
        fold_engine_metrics(self.metrics, self.stats())
        return self.metrics

    def write_trace(self, path: str):
        """Write the tracer's retained records as Perfetto trace_event
        JSON.  Requires tracing on."""
        if self._tr is None:
            raise ValueError(
                "tracing is off: pass trace=TraceConfig() at construction "
                "or call enable_trace() first")
        _write_trace(self._tr, path)

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
            "slot_occupancy": self._occupied_step_sum / cap,
            "replans": self.replans,
            "migrations": self.migrations,
            "migration_copies": self.migration_copies,
            "throughput_tok_s": gen / wall if wall > 0 else 0.0,
            "ttft_s": [r.t_first - r.t_submit for r in reqs],
            "latency_s": [r.t_done - r.t_submit for r in reqs],
            "ticks": self.ticks,
            "phase_time_s": dict(self.phase_time),
            "cache": self.cache_stats(),
            "utilization": self.utilization_stats(),
            "plan_label": (self.plan.label if self.plan is not None
                           else "mono"),
            **({"plan_stages": self.plan.n_stages,
                "decode_replicas": self.plan.n_replicas,
                "prefill_chunk": self.plan.chunk}
               if self.plan is not None else {}),
        }

    # -- internals ---------------------------------------------------------
    def _sync(self, x) -> np.ndarray:
        """Copy a device value to the host, charging the wait to the
        ``host_sync`` bucket (an overlay of whichever phase is open)."""
        t0 = time.perf_counter()
        arr = x.cpu().numpy()
        self.phase_time["host_sync"] += time.perf_counter() - t0
        return arr

    def _to_device(self, arr: np.ndarray):
        """A host array as a tensor on the engine's device, without a
        host sync: on CUDA through a fresh pinned buffer copied with
        ``non_blocking=True`` (a copy from pageable memory waits for the
        stream, so it would serialize an overlapped dispatch behind the
        step in flight; a fresh buffer is safe because the caching host
        allocator reuses it only after the copy's event).  On a CPU
        engine, a copy of the array."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()

    def _readback(self, x):
        """Enqueue the copy of a step's output tokens to the host, right
        after the step: on CUDA into a fresh pinned buffer with
        ``non_blocking=True`` (valid only once the event recorded after
        it completes); on a CPU engine the tensor itself."""
        if self.device.type != "cuda":
            return x
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x, non_blocking=True)
        return host

    def _padded_len(self, n: int) -> int:
        b = max(self.prefill_bucket, 1)
        pp = min(-(-n // b) * b, self.max_seq - 1)
        if self._ring_min:
            # never pad past a sliding window; a prompt longer than the
            # window prefills at its exact length (its own tail wraps the
            # ring, as the gold one-shot prefill's does)
            pp = n if n > self._ring_min else min(pp, self._ring_min)
        return pp

    def _free_slots(self):
        return [s for s in range(self.slots)
                if self._slot_req[s] is None and s not in self._reserved]

    def _replica_views(self, plan, full):
        """One view of the full cache per decode replica: dense leaves
        sliced to its slot range, the paged pools whole."""
        return [T.slice_cache_slots(full, a, b - a)
                for a, b in (plan.replica_range(r)
                             for r in range(plan.n_replicas))]

    def _runtime_for(self, splan):
        """The (cached) PlanRuntime of a ServingPlan: a re-plan back to a
        design point seen before reuses its runtime."""
        rt = self._rt_cache.get(splan)
        if rt is None:
            rt = PlanRuntime(self.model, splan, self.max_seq)
            self._rt_cache[splan] = rt
        return rt

    def _pick_slot(self, free):
        """Admission slot choice: the first free slot, or in plan mode a
        free slot on the least-loaded replica, so admissions spread over
        the decode replicas."""
        if self.plan is None:
            return free[0]
        load = [0] * self.plan.n_replicas
        for s in range(self.slots):
            if self._slot_req[s] is not None or s in self._reserved:
                load[self.plan.replica_of_slot(s)[0]] += 1
        return min(free,
                   key=lambda s: (load[self.plan.replica_of_slot(s)[0]], s))

    def _admit(self):
        while self.queue:
            req = self.queue[0]
            free = self._free_slots()
            if not free:
                return
            slot = self._pick_slot(free)
            ok = (self._admit_one_plan(req, slot)
                  if self.plan is not None else self._admit_one(req, slot))
            if not ok:
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
        else:
            reused, slen = 0, plen
            toks = np.zeros((1, self._padded_len(plen)), np.int32)
            toks[0, :plen] = req.prompt
            t0 = time.perf_counter()
            nxt, self._cache = self._prefill_slot(
                self.params, self._cache, toks, slot, plen)
            tok = int(self._sync(nxt)[0])
        self._prefill_window += time.perf_counter() - t0
        if self._tr is not None:
            self._tr.span(("stage", 0), "prefill", t0, args={
                "uid": req.uid, "slot": slot, "tokens": slen,
                "reused": reused, "plan": "mono"})
        self.prefill_batch_sizes.append(1)
        self.prefill_token_counts.append(slen)
        self.prefill_chunk_counts.append(1)
        self._activate(req, slot, tok)
        return True

    # ---- plan-driven admission (chunked prefill as plan stages) ----------
    def _admit_one_plan(self, req: Request, slot: int) -> bool:
        """Reserve the slot and enter the chunked-prefill pipeline: the
        prompt streams through the plan's stage slices one stage-step a
        tick.  A paged admission reserves the prompt's pool blocks up
        front (its table row maps them only at commit, so a reserved slot
        riding along in its replica's decode writes nothing)."""
        replica, local = self.plan.replica_of_slot(slot)
        reused = 0
        tables = None
        if self._pager is not None:
            ap = self._pager.admit(slot, req.prompt,
                                   req.max_new_tokens + self._spec_k,
                                   reuse_compute=self._suffix_reuse)
            if ap is None:
                return False
            reused = ap.reused_tokens
            tables = (ap.block_table, ap.write_table)
        self._reserved.add(slot)
        self._pf.admit(req, slot, replica, local, reused=reused,
                       tables=tables)
        self.prefill_batch_sizes.append(1)
        self.prefill_token_counts.append(len(req.prompt) - reused)
        self.prefill_chunk_counts.append(len(self._pf.items[-1].chunks))
        return True

    def _chunk_committed(self, slot: int, tokens_done: int):
        """A chunk left the last stage with its pool pages written:
        publish the slot's newly completed blocks for prefix reuse now,
        before the whole admission finishes."""
        if self._pager is not None:
            self._pager.commit_chunk(slot, tokens_done)
            if self._tr is not None:
                self._tr.instant("requests", "commit", args={
                    "slot": slot, "tokens_done": tokens_done})

    def _finish_prefill(self, item):
        """The last chunk left the last stage: take the first token (the
        head of the runtime the item was admitted under), scatter the
        request's batch-1 dense leaves (all of them on a dense cache; the
        mamba state on a paged one, whose K/V already sit in the pool)
        into its slot, and start decoding.  The slot lands in the CURRENT
        binding: after a re-plan, the view of the replica that holds it
        now, or the whole cache on the monolithic point."""
        logits = (item.rt or self._rt).head(self.params, item.final_hidden)
        tok = int(self._sync(torch.argmax(logits[:, -1], dim=-1))[0])
        if self.plan is not None:
            replica, local = self.plan.replica_of_slot(item.slot)
            view = self._caches[replica]
        else:
            view, local = self._cache, item.slot
        if self.paged:
            T.merge_prefill_view(view, item.part_cache, local)
            self._pager.commit(item.slot)
        else:
            T.scatter_cache_slot(view, item.part_cache, local)
        self._reserved.discard(item.slot)
        self._activate(item.req, item.slot, tok)

    def _activate(self, req: Request, slot: int, first_token: int):
        req.slot = slot
        req.t_first = time.perf_counter()
        if self._tr is not None:
            # zero-width admit marker where the request's flow starts (it
            # lands on the retire marker)
            self._tr.span("requests", "admit", req.t_first, req.t_first,
                          args={"uid": req.uid, "slot": slot,
                                "queued_s": req.t_first - req.t_submit},
                          flow_out=req.uid)
        req.out_tokens.append(first_token)
        self._slot_req[slot] = req
        self._pos[slot] = len(req.prompt)
        self._cur[slot, 0] = first_token
        self._cur_known[slot] = True
        if self._overlap and self._cur_dev is not None:
            # patch the fresh slot's input into the device-side token
            # chain, in place: stream order puts this fill after every
            # enqueued step's read of the buffer and copy into it (the
            # other slots' entries are undrained outputs and stay)
            self._cur_dev[slot, 0] = first_token
        self._maybe_retire(slot, req.t_first)

    def _prepare_paged_writes(self):
        """Before a decode tick: make every active slot's target block
        writable -- allocate at page boundaries, copy-on-write shared or
        registered blocks (the device page copy runs here, on the one
        pool every replica fronts)."""
        for slot in range(self.slots):
            if self._slot_req[slot] is None:
                continue
            cow = self._pager.prepare_decode(slot, int(self._pos[slot]))
            if cow is not None:
                T.copy_cache_pages(self._cache, *cow)

    def _decode_batches(self):
        """(replica, first, last) of each decode batch this tick: all the
        slots on a monolithic engine (replica None); in plan mode each
        replica that has an active slot, over its slot range."""
        if self.plan is None:
            return [(None, 0, self.slots)]
        out = []
        for r in range(self.plan.n_replicas):
            a, b = self.plan.replica_range(r)
            if any(self._slot_req[s] is not None for s in range(a, b)):
                out.append((r, a, b))
        return out

    def _note_decode_util(self):
        """Occupied and dispatched slot-steps per replica at a decode
        dispatch (always on; a monolithic engine is replica 0 over all
        slots).  Returns {replica: occupied slots} for the trace spans."""
        if self.plan is None:
            act = self.active
            self._replica_busy[0] = self._replica_busy.get(0, 0) + act
            self._replica_cap[0] = self._replica_cap.get(0, 0) + self.slots
            return {0: act}
        out = {}
        for r in range(self.plan.n_replicas):
            a, b = self.plan.replica_range(r)
            act_r = sum(self._slot_req[s] is not None for s in range(a, b))
            self._replica_busy[r] = self._replica_busy.get(r, 0) + act_r
            self._replica_cap[r] = self._replica_cap.get(r, 0) + (b - a)
            out[r] = act_r
        return out

    def _step_inputs(self, tokens):
        """(replica, first, last, tokens, positions, block_tables) of each
        decode batch, every input on the device before any step runs
        (``_to_device``).  ``tokens`` is a host array (sync mode) or the
        device-side token chain (overlap), sliced per batch."""
        tables = (self._pager.table_matrix() if self._pager is not None
                  else None)
        return [(r, a, b,
                 tokens[a:b] if torch.is_tensor(tokens)
                 else self._to_device(tokens[a:b]),
                 self._to_device(self._pos[a:b]),
                 None if tables is None else self._to_device(tables[a:b]))
                for r, a, b in self._decode_batches()]

    def _decode_step(self, r, cur, pos, bt):
        """One batch's greedy decode step: the monolithic ``serve_step``
        (replica None) or replica ``r``'s stage walk.  Returns the next
        tokens (B, 1) int32 on the device."""
        if r is None:
            nxt, _, self._cache = self.serve_step(self.params, self._cache,
                                                  cur, pos, bt)
            return nxt
        logits = self._rt.walk(self.params, self._caches[r], cur, pos, bt)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]

    def _span_args(self, r, a, b, racts):
        return {"active": racts.get(0 if r is None else r, 0),
                "slots": b - a,
                "plan": self.plan.label if self.plan is not None else "mono"}

    def _decode_once(self):
        """One batched decode step at per-slot positions (in plan mode one
        per replica, each walking the plan's stage slices).  Idle slots
        ride along at fixed shape: on a paged cache their tables are all
        sentinel, so their writes land in the sink page; on a dense one
        their rows are rewritten whole when the slot is next admitted.
        With speculation on, a tick whose drafter finds something runs a
        batched verify step instead."""
        act = self.active
        racts = self._note_decode_util()
        drafts = self._draft_all() if self._spec_k else None
        if drafts is not None:
            self._decode_verify(drafts)
        else:
            # every slot's target block is made writable first (a slot's
            # table row changes only by its own preparation); then every
            # replica's step is dispatched before any result is read back,
            # so the device runs them back to back
            if self._pager is not None:
                self._prepare_paged_writes()
            tr = self._tr
            pending = []
            for r, a, b, cur, pos, bt in self._step_inputs(self._cur):
                td = time.perf_counter() if tr is not None else 0.0
                pending.append((self._decode_step(r, cur, pos, bt), a, b,
                                r, td))
            arrs = []
            for nxt, a, b, r, td in pending:
                arrs.append((self._sync(nxt), a, b))
                if tr is not None:
                    tr.span(("replica", 0 if r is None else r), "decode", td,
                            args=self._span_args(r, a, b, racts))
            now = time.perf_counter()
            for arr, a, b in arrs:
                self._collect_decoded(arr, a, b, now)
        self.decode_steps += 1
        self._decode_slot_steps += act
        self._occupied_step_sum += self.active

    # -- overlapped decode -------------------------------------------------
    def _dispatch_decode(self):
        """Overlap mode: dispatch one batched decode step (per replica in
        plan mode) WITHOUT reading its result back.  Its input tokens come
        from ``_cur_dev``, the previous step's output, still on the
        device; positions and page bookkeeping advance at dispatch, and
        the output tokens' copy to pinned host memory is enqueued right
        after each step, an event after the last.  No host sync: the
        inputs go through ``_to_device``.

        A slot the pending drain is about to retire (EOS or budget, known
        only once step N is read back) rides along one extra step.  That
        garbage write is safe: ``prepare_decode`` made its target block
        exclusively owned, a retired slot's blocks free only after this
        dispatch, and every later cache write is serialized behind this
        step on the one stream -- a reused page is rewritten by its new
        owner's prefill or masked until its new owner's frontier reaches
        it.  The record's entry is skipped as stale at drain."""
        act = self.active
        racts = self._note_decode_util()
        tr = self._tr
        if self._cur_dev is None:
            self._cur_dev = self._to_device(self._cur)
        if self._pager is not None:
            self._prepare_paged_writes()
        arrs, rng = [], []
        for r, a, b, cur, pos, bt in self._step_inputs(self._cur_dev):
            td = time.perf_counter() if tr is not None else 0.0
            nxt = self._decode_step(r, cur, pos, bt)
            self._cur_dev[a:b].copy_(nxt)
            arrs.append((self._readback(nxt), a, b))
            rng.append((a, b))
            if tr is not None:
                tr.span(("replica", 0 if r is None else r),
                        "decode_dispatch", td,
                        args=self._span_args(r, a, b, racts))
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        entries = []
        in_toks: Dict[int, Optional[int]] = {}
        for a, b in rng:
            for slot in range(a, b):
                req = self._slot_req[slot]
                if req is None:
                    continue
                entries.append((slot, req, int(self._pos[slot])))
                # the step's input token: host-known right after
                # activation, else the undrained previous step's output,
                # filled in at that step's drain
                in_toks[slot] = (int(self._cur[slot, 0])
                                 if self._cur_known[slot] else None)
                self._cur_known[slot] = False
                self._pos[slot] += 1
        self._inflight.append(_Inflight(arrs=arrs, event=event,
                                        entries=entries, in_toks=in_toks))
        self.decode_steps += 1
        self._decode_slot_steps += act

    def _drain_one(self):
        """Read back the OLDEST in-flight step and do what the sync path
        does after a step: extend the block chains with the step's input
        tokens, append the output tokens, retire EOS/budget slots (one
        tick later than sync mode; the streams are the same), and hand
        each drained token to the next in-flight record, whose input it
        is."""
        td = time.perf_counter() if self._tr is not None else 0.0
        rec = self._inflight.pop(0)
        if rec.event is not None:
            t0 = time.perf_counter()
            rec.event.synchronize()
            self.phase_time["host_sync"] += time.perf_counter() - t0
            arrs = [(h.numpy(), a, b) for h, a, b in rec.arrs]
        else:
            arrs = [(self._sync(h), a, b) for h, a, b in rec.arrs]
        now = time.perf_counter()
        nxt_rec = self._inflight[0] if self._inflight else None
        nxt_req = ({s: r for s, r, _ in nxt_rec.entries}
                   if nxt_rec is not None else {})
        for arr, a, b in arrs:
            for slot, req, pos_snap in rec.entries:
                if not (a <= slot < b) or self._slot_req[slot] is not req:
                    continue      # another batch's, or retired mid-flight
                if self._pager is not None:
                    tok_in = rec.in_toks[slot]
                    assert tok_in is not None, slot
                    self._pager.note_written(slot, tok_in, pos_snap)
                tok = int(arr[slot - a, 0])
                req.out_tokens.append(tok)
                self._cur[slot, 0] = tok
                self._cur_known[slot] = True
                if nxt_req.get(slot) is req:
                    nxt_rec.in_toks[slot] = tok
                self.decode_tokens += 1
                self._maybe_retire(slot, now, pos=pos_snap + 1)
        self._occupied_step_sum += self.active
        if self._tr is not None:
            self._tr.span("tick", "drain", td, args={
                "slots_drained": len(rec.entries),
                "inflight": len(self._inflight)})

    def _drain_inflight(self):
        """Land every undrained step (overlap mode) and drop the
        device-side token chain: afterwards the host state is what sync
        mode would hold, and the next dispatch starts from ``_cur``."""
        while self._inflight:
            self._drain_one()
        self._cur_dev = None

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
        """Before a verify tick: make every window position's block
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
        if self._pager is not None:
            self._prepare_verify_writes(sw)
        tr = self._tr
        pending = []
        for r, a, b, win, pos, bt in self._step_inputs(window):
            td = time.perf_counter() if tr is not None else 0.0
            if r is None:
                outs, self._cache = self._verify_step(
                    self.params, self._cache, win, pos, bt)
            else:
                outs = torch.argmax(self._rt.walk(
                    self.params, self._caches[r], win, pos, bt), dim=-1)
            pending.append((outs, a, b, r, td))
        arrs = []
        for outs, a, b, r, td in pending:
            arrs.append((self._sync(outs), a, b))
            if tr is not None:
                tr.span(("replica", 0 if r is None else r), "verify", td,
                        args={"window": sw,
                              "drafted": sum(map(len, drafts.values())),
                              "plan": (self.plan.label if self.plan
                                       is not None else "mono")})
        now = time.perf_counter()
        for arr, a, b in arrs:
            self._collect_verified(window, arr, drafts, a, b, now)
        self.spec_steps += 1

    def _collect_verified(self, window, outs, drafts, a: int, b: int,
                          now: float):
        """Greedy acceptance per slot: position j's argmax is what a
        sequential decode would emit after consuming window[0..j], so the
        emitted prefix extends exactly while each argmax equals the next
        drafted token (and is not EOS)."""
        for slot in range(a, b):
            req = self._slot_req[slot]
            if req is None:
                continue
            d = drafts.get(slot, [])
            pos = int(self._pos[slot])
            row = outs[slot - a]
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

    def _collect_decoded(self, arr, a: int, b: int, now: float):
        for slot in range(a, b):
            req = self._slot_req[slot]
            if req is None:
                continue
            if self._pager is not None:
                # the step wrote this slot's INPUT token's K/V at _pos
                self._pager.note_written(slot, int(self._cur[slot, 0]),
                                         int(self._pos[slot]))
            self._pos[slot] += 1
            tok = int(arr[slot - a, 0])
            req.out_tokens.append(tok)
            self._cur[slot, 0] = tok
            self.decode_tokens += 1
            self._maybe_retire(slot, now)

    def _maybe_retire(self, slot: int, now: float,
                      pos: Optional[int] = None):
        """Slot-level retirement: EOS, token budget, or a full slot cache.
        Paged engines release the slot's blocks (registered ones park in
        the pool's LRU for prefix reuse).  ``pos``: the slot's written
        tokens as of the step being accounted; an overlap drain passes it
        because ``_pos`` has already advanced for the step in flight."""
        if pos is None:
            pos = int(self._pos[slot])
        req = self._slot_req[slot]
        if (len(req.out_tokens) >= req.max_new_tokens
                or (req.eos_token is not None
                    and req.out_tokens[-1] == req.eos_token)
                or pos >= self.max_seq - 1):
            req.t_done = now
            self.done.append(req)
            self._slot_req[slot] = None
            if self._pager is not None:
                self._pager.release_slot(slot)
            self._h_ttft.observe(req.t_first - req.t_submit)
            n = max(len(req.out_tokens) - 1, 1)
            self._h_tpot.observe((req.t_done - req.t_first) / n)
            self._c_requests.inc()
            self._c_gen.inc(len(req.out_tokens))
            if self._tr is not None:
                self._tr.span("requests", "retire", now, now, args={
                    "uid": req.uid, "slot": slot,
                    "tokens": len(req.out_tokens),
                    "latency_s": req.t_done - req.t_submit},
                    flow_in=req.uid)
