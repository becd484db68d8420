"""Plan-driven serving of the port: a ``ServingPlan`` run by the engine.

The counterpart of the JAX package's ``plan/serving.py``.  One searched
plan gives the paper's two regimes under live traffic:

  * **chunked prefill as plan stages**: an admitted prompt is cut into
    ``chunk``-token chunks that stream through the plan's (uneven) stage
    slices.  ``PrefillPipeline`` advances every chunk in flight by at most
    ONE stage a tick, with at most one chunk on each stage, so a long
    prompt never stalls decode for its whole length;
  * **spatial decode replicas**: the plan's spatial width
    (``n_microbatches``) becomes N slot-partitioned decode replicas, each
    running ``stage_walk``, a batched decode that walks the stage slices
    in order.

Numerical contract (held by ``tests/test_torch_plan_serving.py``): every
stream through a ServingPlan equals the isolated one-shot decode and the
JAX plan engine's stream.  (1) A stage walk runs the same per-group ops
in the same order as the whole stack; (2) a chunk's first pass
(``cont=False``) is the one-shot prefill branch, and continuation chunks
attend the position-ordered cache (``layers.multi_head_attention(
attend_cache=True)``); (3) recurrent state (mamba, mLSTM, sLSTM)
threads between chunks exactly.
Chunking turns itself off where exactness cannot hold (``split_chunks``).

On one card every stage and replica runs on ``model.device``,
time-multiplexed, as the JAX package's do on one host device
(``place_params`` passes the params through there, as JAX's does; on
several cards it puts a uniform plan's stages on their mesh slots, but
the engine does not call it, as JAX's does not).  The functions here are
plain functions of tensors: the JAX package's ``jax.jit``/donation wrappers and
its per-stage step factories have no counterpart, and every step writes
the cache it is given in place.  A live re-plan (``ServingEngine.replan``)
drains and rebinds the pipeline: each item keeps the ``PlanRuntime`` it
was admitted under (``_PrefillItem.rt``), so its remaining chunks walk
the stage slices they started on, and a new pipeline ``adopt``s it.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, List

import numpy as np
import torch

from repro_torch.launch.mesh import local_devices, make_plan_mesh
from repro_torch.models import transformer as T
from repro_torch.pipeline.executor import _to, run_stage
from repro_torch.plan.ir import ExecutionPlan, ServingPlan
from repro_torch.sharding.execute import plan_rank_tree
# the embed / final-norm + head / stage-slice helpers are shared with the
# validation path, so the parity contract has one implementation per term
from repro_torch.plan.validate import _embed, _finish, _stage_slice


def _positions(positions, device):
    return torch.as_tensor(positions, device=device).to(torch.int64)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def prefill_stage(model, plan: ExecutionPlan, params, s: int, cont: bool,
                  hidden, pos_base: int, part_cache, replica_cache=None,
                  block_tables=None, write_tables=None):
    """One prefill stage-step: stage ``s``'s group slice over a chunk's
    hidden states, writing only that stage's group range of the caches
    (in place).  Returns the hidden states leaving the stage.

    cont=False is the chunk-0 pass (the one-shot prefill branch); cont=True
    a continuation (the chunk also attends the ``pos_base`` tokens already
    in the cache).  Dense: the request's batch-1 ``part_cache`` holds every
    leaf.  Paged (``block_tables`` given): the chunk's K/V stream straight
    into the replica's pool pages through ``write_tables`` (shared warm
    blocks carry the sentinel, so their writes drop) and every query
    attends the whole mapped prefix; ``part_cache`` holds only the dense
    leaves (mamba state).  ``pos_base`` counts reused warm-prefix tokens
    plus earlier chunks."""
    view = part_cache if block_tables is None else \
        T.combine_prefill_parts(replica_cache, part_cache)
    st = plan.stages[s]
    y, _, _ = run_stage(
        model.cfg, _stage_slice(params["stack"], plan, s), hidden,
        cache=T.slice_cache_groups(view, st.first_group, st.n_groups),
        cache_index=int(pos_base), attend_cache=cont,
        block_tables=block_tables, write_tables=write_tables)
    return y


def stage_walk(model, plan: ExecutionPlan, params, cache, tokens,
               positions, block_tables=None):
    """One replica's decode or verify step: embed, every stage's slice in
    order against its group range of the replica's cache (per-slot
    ``positions``; ``block_tables`` (B, NB) when the cache is paged), then
    the final norm + head.  The same ops in the same order as the
    monolithic ``serve_step``: the group loop is only cut at stage
    boundaries.  Returns f32 logits (B, S, V); the engine takes the argmax
    at the last position (decode) or at every one (verify)."""
    dev = model.device
    x = _embed(model, params, {"tokens": tokens})
    positions = _positions(positions, dev)
    if block_tables is not None:
        block_tables = torch.as_tensor(block_tables, device=dev)
    for s, st in enumerate(plan.stages):
        x, _, _ = run_stage(
            model.cfg, _stage_slice(params["stack"], plan, s), x,
            cache=T.slice_cache_groups(cache, st.first_group, st.n_groups),
            cache_index=positions, block_tables=block_tables)
    return _finish(model, params, x)


def place_params(params, plan: ExecutionPlan, devices=None, par=None):
    """One stage-sharded copy of the params on a ``make_plan_mesh`` of
    ``devices`` (default: every local CUDA device).  Returns (params,
    mesh), or (params, None) unchanged when the devices are fewer than the
    stages or are all one device (``[cuda:0] * 2``: the slots share the
    card, and the params stay where they are).

    One process a mesh rank (``par``, a ``sharding.Parallel`` over the
    plan mesh): returns (this rank's tree, None): its stage's groups,
    each leaf its ``model`` shard, the embedding on stage 0 and the final
    norm and head on the last stage, copied onto the rank's device
    (``sharding.plan_rank_tree``); ``devices`` is not read.  The caller
    may then drop the full params: the tree holds no view of them.

    A uniform plan whose stage count divides the groups puts each stage's
    groups on its slot's lead device, JAX's ``P("stage")``.  Every other
    leaf is replicated, which in one process means one tensor on the
    mesh's lead device (slot 0's): the embed and the head read it there,
    and ``make_plan_runner`` copies the groups a stage runs onto the
    stage's device at each call (nothing where it is the lead device), as
    JAX's step takes a stage's shard out of a replicated leaf.  The engine
    does not call this, as JAX's does not."""
    if par is not None:
        return plan_rank_tree(params, plan, par), None
    devs = [torch.device(d) for d in (devices if devices is not None
                                      else local_devices("cuda"))]
    S = plan.n_stages
    if len(devs) < S or len(set(devs)) == 1:
        return params, None
    mesh = make_plan_mesh(plan, devices=devs)
    lead = [mesh.devices[s].flat[0] for s in range(S)]
    per_stage = plan.num_groups // S
    shard = plan.is_uniform and plan.num_groups % S == 0
    out = {k: _to(v, lead[0]) for k, v in params.items() if k != "stack"}
    out["stack"] = [_to(g, lead[i // per_stage] if shard else lead[0])
                    for i, g in enumerate(params["stack"])]
    return out, mesh


# ---------------------------------------------------------------------------
# chunked-prefill pipeline (host-side scheduling)
# ---------------------------------------------------------------------------

@dataclass(eq=False)
class _Flight:
    ci: int                 # chunk index within its request
    si: int                 # next stage this chunk will execute
    hidden: Any             # (1, L, d) activations entering stage si
    pos_base: int           # tokens of this request already in the cache


@dataclass(eq=False)
class _PrefillItem:
    req: Any                # serving.Request
    slot: int               # global engine slot (reserved)
    replica: int
    local_slot: int
    chunks: List[np.ndarray]        # (1, L) token chunks, exact lengths
    part_cache: Any                 # batch-1 cache being built (paged
    #                                 items: the dense remainder only;
    #                                 the K/V go to the replica's pool)
    next_chunk: int = 0
    flight: List[_Flight] = field(default_factory=list)
    final_hidden: Any = None
    reused: int = 0                 # warm-prefix tokens whose prefill is
    #                                 skipped (the chunks cover the suffix)
    bt: Any = None                  # (1, max_blocks) gather table (paged)
    wt: Any = None                  # (1, max_blocks) fresh-write table
    rt: Any = None                  # the PlanRuntime this item was admitted
    #                                 under: after a re-plan its remaining
    #                                 chunks finish on it, while new
    #                                 admissions and decode bind the new
    #                                 plan


class PlanRuntime:
    """The steps and the chunking policy of one (model, ServingPlan).
    ``walk`` (a replica's decode or verify step, logits out) and ``head``
    (the final norm and head at a prefill's last position) are the
    engine's only calls into the model in plan mode."""

    def __init__(self, model, splan: ServingPlan, max_seq: int):
        cfg = model.cfg
        T.check_supported(cfg)
        if cfg.family in ("audio", "vision", "vlm") or cfg.mrope_sections:
            raise NotImplementedError(
                "plan-driven serving covers token-LM families "
                "(dense/moe/hybrid/ssm)")
        self.model = model
        self.splan = splan
        self.max_seq = max_seq
        plan = splan.plan
        if plan.num_groups != cfg.num_groups:
            raise ValueError(
                f"the plan cuts {plan.num_groups} groups but {cfg.name} "
                f"has {cfg.num_groups}")
        # chunking exactness gates, as in JAX: MoE capacity is per call
        # (chunk-local routing would differ from the one-shot prefill),
        # and a prompt that wraps a sliding-window ring must wrap it in
        # one shot as the gold prefill does
        self._moe = any(b.ffn == "moe" for b in cfg.block_pattern)
        self._ring_min = min(
            (min(max_seq, cfg.window_size)
             for b in cfg.block_pattern if b.mixer == "attn_local"),
            default=0)

    def walk(self, params, cache, tokens, positions, block_tables=None):
        """``stage_walk`` of this plan: f32 logits (B, S, V)."""
        return stage_walk(self.model, self.splan.plan, params, cache,
                          tokens, positions, block_tables)

    def head(self, params, hidden):
        """Final norm and head at the last (exact-length) position of a
        prefill's hidden states (1, L, d): f32 logits (1, 1, V)."""
        return _finish(self.model, params, hidden[:, -1:])

    def split_chunks(self, prompt: np.ndarray) -> List[np.ndarray]:
        """(1, L) chunks of exact lengths: ``chunk`` tokens each and the
        remainder last, or the whole prompt as one chunk where a gate
        holds (MoE, a ring the prompt wraps, ``plen <= chunk``)."""
        plen = len(prompt)
        c = self.splan.chunk
        if self._moe or (self._ring_min and plen > self._ring_min) \
                or plen <= c:
            cuts = [plen]
        else:
            cuts = [c] * (plen // c)
            if plen % c:
                cuts.append(plen % c)
        out, a = [], 0
        for n in cuts:
            out.append(np.asarray(prompt[a:a + n], np.int32)[None])
            a += n
        return out


class PrefillPipeline:
    """In-flight chunked prefills, advanced one stage-step a tick.

    Occupancy rule: at most one chunk executes on each stage per tick
    (the stages stand for distinct accelerators), and the chunks of one
    request stay in order (a chunk never enters a stage before its
    predecessor has left it: its stage-range cache writes land first).
    ``step`` returns the items that finished this tick.  With a
    ``tracer`` (``repro_torch.obs.Tracer``) every stage-step of a chunk
    records a ``prefill_chunk`` span on its stage's track."""

    def __init__(self, runtime: PlanRuntime, params, tracer=None):
        self.rt = runtime
        self.params = params
        self.items: List[_PrefillItem] = []
        self.tracer = tracer
        self.last_stages_run: frozenset = frozenset()  # stages that ran a
        #                                 chunk in the last step()

    @property
    def busy(self) -> bool:
        return bool(self.items)

    def admit(self, req, slot: int, replica: int, local_slot: int,
              reused: int = 0, tables=None):
        """Queue a chunked prefill.  Paged admissions pass the pager's
        ``tables=(block_table, write_table)``: the chunks then write their
        K/V straight into the replica's pool pages, ``part_cache`` holds
        only the dense remainder, and ``reused`` warm-prefix tokens are
        skipped (the chunks cover the suffix)."""
        model = self.rt.model
        chunks = self.rt.split_chunks(req.prompt[reused:])
        if tables is not None:
            part_cache = T.make_prefill_part(model.cfg, self.rt.max_seq,
                                             device=model.device)
            bt = torch.as_tensor(np.asarray(tables[0])[None],
                                 device=model.device)
            wt = torch.as_tensor(np.asarray(tables[1])[None],
                                 device=model.device)
        else:
            part_cache = model.init_cache(1, self.rt.max_seq)
            bt = wt = None
        self.items.append(_PrefillItem(
            req=req, slot=slot, replica=replica, local_slot=local_slot,
            chunks=chunks, part_cache=part_cache, reused=reused,
            bt=bt, wt=wt, rt=self.rt))

    def adopt(self, items: List[_PrefillItem]):
        """Take over the items in flight of an earlier pipeline (a
        re-plan's drain-and-rebind).  Each keeps its own ``rt``; the
        engine remaps its ``replica`` and ``local_slot`` first."""
        self.items.extend(items)

    def _run_stage(self, it: _PrefillItem, si: int, cont: bool, hidden,
                   pos_base: int, caches, ci: int):
        """Execute one stage for chunk ``ci`` of an item, on the stage
        slices of the runtime it was admitted under; paged items go
        through their replica's cache view."""
        rt = it.rt or self.rt
        tr = self.tracer
        t0 = time.perf_counter() if tr is not None else 0.0
        out = prefill_stage(
            rt.model, rt.splan.plan, self.params, si, cont, hidden,
            pos_base, it.part_cache,
            None if it.bt is None else caches[it.replica], it.bt, it.wt)
        if tr is not None:
            tr.span(("stage", si), "prefill_chunk", t0, args={
                "uid": int(getattr(it.req, "uid", -1)), "slot": it.slot,
                "replica": it.replica, "chunk": ci,
                "tokens": int(hidden.shape[1]), "cont": bool(cont)})
        return out

    def _chunk_exited(self, it: _PrefillItem, fl: _Flight, finished,
                      on_chunk):
        """A chunk just left the last stage: its pool pages are written --
        let the engine publish the completed blocks, and collect the item
        if that was its final chunk."""
        if it.bt is not None and on_chunk is not None:
            done = it.reused + sum(c.shape[1]
                                   for c in it.chunks[:fl.ci + 1])
            on_chunk(it.slot, done)
        if fl.ci == len(it.chunks) - 1:
            it.final_hidden = fl.hidden
            finished.append(it)

    def step(self, caches=None, on_chunk=None) -> List[_PrefillItem]:
        """Advance every chunk in flight by at most one stage, then inject
        the next chunk of the first item that has one into stage 0 when
        that stage is free.

        caches: the engine's per-replica cache views, REQUIRED when paged
        items are in flight; on_chunk(slot, tokens_done) fires each time a
        paged chunk clears the last stage."""
        # per item: after a re-plan, an item still walks the stages it
        # was admitted under
        def n_stages(it):
            return (it.rt or self.rt).splan.n_stages

        occupied = set()
        finished: List[_PrefillItem] = []

        # deepest stage first (a vacated stage is not re-entered in the
        # same tick); ties go to the earlier chunk / earlier item (FIFO)
        work = [(it, fl) for it in self.items for fl in it.flight]
        work.sort(key=lambda w: (-w[1].si, w[1].ci))
        for it, fl in work:
            if fl.si in occupied:
                continue
            occupied.add(fl.si)
            fl.hidden = self._run_stage(
                it, fl.si, fl.ci > 0 or it.reused > 0, fl.hidden,
                fl.pos_base, caches, fl.ci)
            fl.si += 1
            if fl.si == n_stages(it):
                it.flight.remove(fl)
                self._chunk_exited(it, fl, finished, on_chunk)

        # inject next chunks at stage 0 when it is free this tick (the
        # predecessor chunk has always left stage 0: injection runs
        # stage 0 inline, so no flight ever waits at si == 0)
        for it in self.items:
            if it.next_chunk >= len(it.chunks) or 0 in occupied:
                continue
            occupied.add(0)
            tokens = it.chunks[it.next_chunk]
            pos_base = it.reused + sum(c.shape[1]
                                       for c in it.chunks[:it.next_chunk])
            hidden = _embed(self.rt.model, self.params, {"tokens": tokens})
            hidden = self._run_stage(
                it, 0, it.next_chunk > 0 or it.reused > 0, hidden,
                pos_base, caches, it.next_chunk)
            fl = _Flight(ci=it.next_chunk, si=1, hidden=hidden,
                         pos_base=pos_base)
            it.next_chunk += 1
            if fl.si == n_stages(it):
                self._chunk_exited(it, fl, finished, on_chunk)
            else:
                it.flight.append(fl)

        for it in finished:
            self.items.remove(it)
        self.last_stages_run = frozenset(occupied)
        return finished
