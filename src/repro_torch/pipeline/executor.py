"""One plan stage's group slice, the unit of the port's stage walk.

The counterpart of ``run_stage`` in the JAX package's
``pipeline/executor.py``.  That module's multi-device executor
(``plan_stage_params``, ``make_plan_runner``, ``plan_forward``,
``pipeline_forward``: stages on a device mesh, microbatches moved between
them by collective permutes) is not ported yet; on one card every stage
runs on the same device, time-multiplexed, as the JAX package's stages
do on one host device.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T


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
