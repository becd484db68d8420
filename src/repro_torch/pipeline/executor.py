"""The SSR pipeline executor of the port: an ``ExecutionPlan`` run over a
device mesh, the counterpart of the JAX package's ``pipeline/executor.py``.

The unit of work is an ``ExecutionPlan`` (``repro_torch.plan``): ordered
stage slices of the layer stack, not necessarily equal, each on one slot
of a ("stage", "data", "model") ``launch.mesh.Mesh``, with
``n_microbatches`` in flight a round (spatial) and ``n_rounds`` rounds
streamed back to back (sequential).  M microbatches through S stages take
M + S - 1 ticks, the paper's Fig. 1(b).

JAX runs one SPMD program over the mesh and moves microbatches between
stages with ``ppermute``; each stage slot is a data x model submesh
(each SSR accelerator is itself a DPxTP submesh), whose params GSPMD
shards by the rules.  The port runs a plan two ways:

  * ONE process drives every slot (``make_plan_runner`` and
    ``plan_forward`` without ``par``; what the serving engine's plans
    build on): stage s's groups run on slot s's lead device, and its
    output goes to the next slot's device with
    ``Tensor.to(non_blocking=True)``.  No host sync is issued, so stages
    on different cards overlap; slots that list the same card
    (``[cuda:0] * 2``) take turns on it.  A slot's data and model ranks
    do nothing: the slot runs replicated on its lead device.
  * one process a mesh rank (``par``, a ``sharding.Parallel`` over the
    plan mesh; ``launch.mesh.init_distributed`` and ``device_mesh``):
    rank (s, d, m) holds stage s's groups, each leaf its ``model`` shard
    (``sharding.plan_rank_tree``), runs them tensor parallel over
    ``model`` (the layers' Megatron paths) on its block of rows of every
    microbatch (``data``), and hands each finished microbatch to rank
    (s + 1, d, m) (``Parallel.send``/``recv``: JAX's ``ppermute`` over
    "stage").  The embedding runs on stage 0, the final norm and the
    vocab-parallel head (gathered over ``model``) on the last stage,
    whose ranks return their rows' logits; ``gather_logits`` brings them
    to rank 0.  Under FSDP's specs (a ``data`` entry; ``par`` carrying
    them) each group is gathered by its model group index
    (``run_stack(group_ids=)``).

Uneven stages: every stage's group list is padded to ``plan.max_groups``
by a clamped gather (repeating the stage's last real group: list entries,
so the padding shares that group's tensors), and ``run_stack``'s
``group_mask`` skips the dead entries, which launch nothing.  Where JAX
computes the pipeline's bubbles (a stage with no microbatch yet, or none
left) and discards them, the port skips them: a rank idles through its
stage's bubble ticks.

``run_stage`` is one stage's unpadded slice, the unit of the serving
engine's stage walk.  The legacy ``(n_stages, n_microbatches)`` API
survives as shims that lower a uniform plan.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import tree as TR
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.plan.ir import ExecutionPlan, uniform_plan
from repro_torch.plan.validate import _embed, _finish
from repro_torch.sharding.execute import shard_batch


def stage_params_reshape(stack_params, n_stages: int):
    """The per-group param list -> ``n_stages`` lists of equal length, the
    uniform split; uneven plans use ``plan_stage_params``."""
    g = len(stack_params)
    if n_stages < 1 or g % n_stages:
        raise ValueError(f"{n_stages} stages do not divide {g} groups")
    k = g // n_stages
    return [stack_params[s * k:(s + 1) * k] for s in range(n_stages)]


def plan_stage_params(stack_params, plan: ExecutionPlan):
    """The per-group param list -> S lists of ``plan.max_groups`` groups,
    by the plan's clamped gather (``plan.group_index_matrix()``): a short
    stage repeats its last real group, which the runner masks out.  List
    indexing: a padded entry is that group's dict, nothing is copied."""
    return [[stack_params[int(g)] for g in row]
            for row in plan.group_index_matrix()]


def run_stage(cfg: ModelConfig, stage_params, x, *, cache=None,
              cache_index=None, attend_cache: bool = False,
              block_tables=None, write_tables=None):
    """Run ONE stage's group slice.  Returns (y, cache, aux).

    stage_params: the stage's slice of the per-group param list (exactly
      its n_groups entries).
    cache / cache_index: the stage's group-range cache view
      (``T.slice_cache_groups``) and token offset(s); the stage writes it
      in place.  ``attend_cache=True`` is the chunked-prefill continuation
      (the chunk attends the cached tokens, see
      ``models.layers.multi_head_attention``).
    block_tables / write_tables: the page maps of a paged view (decode
      stage walk; chunked prefill, whose shared warm blocks carry the
      sentinel in ``write_tables`` so their writes drop).
    """
    return T.run_stack(stage_params, x, cfg, cache=cache,
                       cache_index=cache_index, block_tables=block_tables,
                       write_tables=write_tables, attend_cache=attend_cache)


def pipeline_spec(stack_params_staged, mesh):
    """Each stage's device: the lead device of its mesh slot (stage s of
    ``stack_params_staged`` runs on ``mesh`` slot s)."""
    n = mesh.shape["stage"]
    if len(stack_params_staged) != n:
        raise ValueError(f"{len(stack_params_staged)} stages on a mesh of "
                         f"{n} stage slots")
    return [mesh.devices[s].flat[0] for s in range(n)]


def _send(t, device):
    """``t`` on ``device``, itself when it is there already; a copy to a
    card is enqueued without a host sync (a copy to the host waits)."""
    return t.to(device, non_blocking=torch.device(device).type == "cuda")


def _to(tree, device):
    """``tree``'s tensors on ``device`` (a placed tree costs nothing)."""
    return TR.tree_map(lambda t: _send(t, device), tree)


def make_plan_runner(cfg: ModelConfig, mesh, plan: ExecutionPlan,
                     par=None) -> Callable:
    """Returns pipelined(params_staged, group_mask, x_mb) -> y_mb; given
    ``par`` (a ``sharding.Parallel`` over the plan mesh ``mesh``), this
    rank's runner (``_rank_runner``).

    params_staged: S lists of ``plan.max_groups`` group dicts
      (``plan_stage_params``); a stage's groups go to its slot's device
      (a no-op where they are already there).
    group_mask: (S, max_groups) 0/1 on the host (``plan.group_mask_matrix``):
      live vs padded groups a stage.
    x_mb: (M_total, mb, seq, d_model) embedded microbatches,
      M_total = plan.n_microbatches * plan.n_rounds.
    y_mb: (M_total, mb, seq, d_model) final hidden states, on the last
      stage's device.

    Tick t: stage 0 takes microbatch t, stage s runs what stage s - 1 sent
    it at tick t - 1, and the last stage banks microbatch t - (S - 1)."""
    if par is not None:
        return _rank_runner(cfg, mesh, plan, par)
    S = plan.n_stages
    M = plan.total_microbatches

    def pipelined(params_staged, group_mask, x_mb):
        devs = pipeline_spec(params_staged, mesh)
        if len(x_mb) != M:
            raise ValueError(f"{len(x_mb)} microbatches for a plan of {M}")
        # live groups only: a padded entry never runs, so it stays put
        params = [[_to(g, d) if float(m) > 0 else g
                   for g, m in zip(p, ms)]
                  for p, ms, d in zip(params_staged, group_mask, devs)]
        inbox = [None] * S          # what each stage runs this tick
        outputs = [None] * M
        for t in range(M + S - 1):
            inbox[0] = _send(x_mb[t], devs[0]) if t < M else None
            sent = [None] * S
            for s in range(S):
                if inbox[s] is None:        # a bubble: nothing to run
                    continue
                y, _, _ = T.run_stack(params[s], inbox[s], cfg,
                                      group_mask=group_mask[s])
                if s == S - 1:
                    outputs[t - (S - 1)] = y
                else:
                    sent[s + 1] = _send(y, devs[s + 1])
            inbox = sent
        return torch.stack(outputs)

    return pipelined


def _rank_runner(cfg: ModelConfig, mesh, plan: ExecutionPlan, par
                 ) -> Callable:
    """This rank's pipelined(params_stage, group_mask, x_mb) -> y_mb, for
    rank (s, d, m) of the plan mesh:

    params_stage: the rank's tree's ``stack`` (``plan_rank_tree``): its
      stage's ``plan.max_groups`` group dicts, its ``model`` shards.
    group_mask: (S, max_groups) on the host; row s masks the padding.
    x_mb: on stage 0, (M_total, rows, seq, d_model): the rank's rows of
      every embedded microbatch; on any other stage a tensor of that
      shape and dtype, read for both only (a ``meta`` tensor will do).
    y_mb: on the last stage, (M_total, rows, seq, d_model), the rank's
      rows of every microbatch's final hidden states; None elsewhere.

    JAX's tick schedule: at tick t stage s runs microbatch t - s, which
    stage 0 takes from ``x_mb`` and every other stage receives from stage
    s - 1; a stage with no microbatch that tick (a bubble) runs nothing.
    A finished microbatch goes to stage s + 1 (``par.send``), or is banked
    on the last stage."""
    S, M = plan.n_stages, plan.total_microbatches
    if mesh.shape.get("stage") != S or par.shape.get("stage") != S:
        raise ValueError(f"a plan of {S} stages on a mesh of "
                         f"{mesh.shape.get('stage')} stage slots and "
                         f"{par.shape.get('stage')} stage ranks")
    s = par.rank("stage")
    ids = plan.group_index_matrix()[s]      # FSDP's group-axis gathers

    def pipelined(params_stage, group_mask, x_mb):
        if len(x_mb) != M:
            raise ValueError(f"{len(x_mb)} microbatches for a plan of {M}")
        shape, dtype = tuple(x_mb.shape[1:]), x_mb.dtype
        outputs = []
        for t in range(M + S - 1):
            m = t - s
            if not 0 <= m < M:              # a bubble: nothing to run
                continue
            x = x_mb[m] if s == 0 else par.recv(shape, dtype)
            y, _, _ = T.run_stack(params_stage, x, cfg,
                                  group_mask=group_mask[s],
                                  group_ids=ids, par=par)
            if s == S - 1:
                outputs.append(y)
            else:
                par.send(y)
        return torch.stack(outputs) if s == S - 1 else None

    return pipelined


def _rank_forward(model, params, batch, mesh, plan: ExecutionPlan):
    """``plan_forward`` one process a rank (``model.par``): see there."""
    cfg, par = model.cfg, model.par
    lead = batch["embeds"] if "embeds" in batch else batch["tokens"]
    B, seq = lead.shape[:2]
    M = plan.total_microbatches
    if B % M:
        raise ValueError(f"batch {B} is not a multiple of the plan's {M} "
                         f"microbatches")
    if B // M % par.dp:
        raise ValueError(f"a microbatch of {B // M} rows does not split "
                         f"over {par.dp} data ranks")
    rows = B // par.dp
    runner = make_plan_runner(cfg, mesh, plan, par=par)
    if par.rank("stage") == 0:
        x = _embed(model, params, shard_batch(batch, par.dmesh, M))
    else:
        x = torch.empty((rows, seq, cfg.d_model),
                        dtype=getattr(torch, cfg.dtype), device="meta")
    y = runner(params["stack"], plan.group_mask_matrix(),
               x.reshape(M, rows // M, seq, cfg.d_model))
    if y is None:
        return None
    return _finish(model, params, y.reshape(rows, seq, cfg.d_model))


def gather_logits(logits, par, batch_size: int, n_microbatches: int,
                  seq: int, vocab: int):
    """The last stage's logits brought to global rank 0 in the batch's
    row order: (batch_size, seq, vocab) f32 there, None on every other
    rank.  A collective over the plan mesh: every rank calls it with its
    ``plan_forward`` result (None off the last stage).  The last stage's
    ranks of model rank 0 all-gather their rows over ``data``; the one
    at data rank 0 sends them along "stage" to rank 0.  Meant for tests
    and checks: the logits cross host memory under gloo (1 GB at B=8,
    S=512, V=64,000)."""
    last = par.shape.get("stage", 1) - 1
    s, d, m = par.rank("stage"), par.data_rank, par.model_rank
    full = None
    if s == last and m == 0:
        got = par.gather_plain(logits, 0, par.data_axes)
        r = batch_size // n_microbatches // par.dp
        full = got.reshape(par.dp, n_microbatches, r, seq, vocab).transpose(
            0, 1).reshape(batch_size, seq, vocab)
    if (d, m) != (0, 0):
        return None
    if last == 0:
        return full
    if s == last:
        par.send(full, shift=-last)
    elif s == 0:
        return par.recv((batch_size, seq, vocab), torch.float32,
                        shift=-last)
    return None


def plan_forward(model, params, batch, mesh, plan: ExecutionPlan):
    """End-to-end plan execution: embed, the pipelined (uneven) stages,
    then the final norm and the head on the model's device -> f32 logits.
    batch: ``{"tokens": (B, S)}`` or ``{"embeds": (B, S, D)}``; B must be
    a multiple of the plan's total microbatches.

    One process a rank (``model.par``, a ``sharding.Parallel`` over the
    plan mesh ``mesh``; ``params`` this rank's tree, ``plan_rank_tree``):
    every rank passes the whole batch and takes its block of rows of
    every microbatch (``sharding.shard_batch(batch, dmesh, M_total)``; a
    microbatch the data axis does not divide raises ValueError); stage 0
    embeds them, the stages run as
    ``_rank_runner`` says, and the last stage's ranks return their rows'
    f32 logits, (M_total * rows, S, V) in that order (the head's
    vocabulary gathered over ``model``); every other rank returns None.
    JAX returns the logits replicated over the mesh; the port does not
    broadcast them (``gather_logits`` brings them to rank 0)."""
    cfg = model.cfg
    if plan.num_groups != cfg.num_groups:
        raise ValueError(f"the plan tiles {plan.num_groups} groups, the "
                         f"model has {cfg.num_groups}")
    if model.par is not None:
        return _rank_forward(model, params, batch, mesh, plan)
    x = _embed(model, params, batch)
    B, seq, d = x.shape
    M = plan.total_microbatches
    if B % M:
        raise ValueError(f"batch {B} is not a multiple of the plan's {M} "
                         f"microbatches")
    x_mb = x.reshape(M, B // M, seq, d)
    staged = plan_stage_params(params["stack"], plan)
    runner = make_plan_runner(cfg, mesh, plan)
    y = runner(staged, plan.group_mask_matrix(), x_mb).reshape(B, seq, d)
    return _finish(model, params, _send(y, x.device))


# ---------------------------------------------------------------------------
# legacy scalar API: thin shims over a uniform plan
# ---------------------------------------------------------------------------

def make_pipeline_runner(cfg: ModelConfig, mesh, n_stages: int,
                         n_microbatches: int) -> Callable:
    """Legacy runner: pipelined(params_staged, x_mb) -> y_mb with equal
    stage slices (``stage_params_reshape``), a uniform plan underneath."""
    plan = uniform_plan(cfg.num_groups, n_stages, n_microbatches)
    runner = make_plan_runner(cfg, mesh, plan)
    mask = plan.group_mask_matrix()

    def pipelined(params_staged, x_mb):
        return runner(params_staged, mask, x_mb)
    return pipelined


def pipeline_forward(model, params, batch, mesh, n_stages: int,
                     n_microbatches: int):
    """Legacy end-to-end forward: lowers to a uniform plan (one process
    a rank under ``model.par``, ``params`` then this rank's tree of that
    plan, ``plan_rank_tree(params, uniform_plan(...), par)``)."""
    plan = uniform_plan(model.cfg.num_groups, n_stages, n_microbatches)
    return plan_forward(model, params, batch, mesh, plan)
