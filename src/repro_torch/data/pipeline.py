"""Deterministic synthetic token pipeline, a copy of the JAX package's
``data/pipeline.py``: batch ``i`` is a pure function of (seed, i), so a
restarted job resumes mid-stream without replaying, and both packages
draw the same batches bit for bit (numpy only).  Each process draws its
slice of the global batch; the process rank and count come from
``torch.distributed`` when a process group is up (0 and 1 otherwise), in
place of ``jax.process_index``/``process_count``.

On a mesh (``mesh=``, a ``DeviceMesh``: sharded training) every rank
draws the one global batch a single process draws, JAX's bit for bit,
and takes the rows ``input_specs_tree`` gives it (``batch_axes_for``'s
axes, ``sharding.shard_batch``): ranks that differ only on ``model``
take the same rows.  With ``grad_accum`` > 1 a rank takes its block of
each global microbatch, as the sharded step's microbatches need.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


def _process():
    """(rank, count) of this process."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _philox(seed: int, step: int, shape, modulo: int) -> np.ndarray:
    """Cheap counter-based generator (splitmix-style) -- stateless."""
    n = int(np.prod(shape))
    with np.errstate(over="ignore"):
        idx = np.arange(n, dtype=np.uint64) + np.uint64(step) * np.uint64(n)
        z = idx + np.uint64(seed) * np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
    return (z % np.uint64(modulo)).astype(np.int32).reshape(shape)


@dataclass
class SyntheticLM:
    """Language-model batches: next-token targets over a synthetic stream
    (and each family's inputs: patch embeddings and class labels for
    vision, frame embeddings and decoder tokens for audio, embeddings with
    M-RoPE positions for vlm -- three equal streams, as JAX draws them)."""
    cfg: ModelConfig
    shape: ShapeConfig
    seed: int = 0
    start_step: int = 0
    mesh: Any = None
    grad_accum: int = 1

    def host_batch(self) -> int:
        pc = _process()[1]
        b = self.shape.global_batch
        if b % pc and pc != 1:
            raise ValueError(f"global batch {b} does not split over {pc} "
                             f"processes")
        return max(b // pc, 1)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = self.start_step
        while True:
            yield self.batch_at(step)
            step += 1

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        if self.mesh is not None:
            from repro_torch.sharding.execute import shard_batch
            return shard_batch(self.global_batch_at(step), self.mesh,
                               self.grad_accum)
        return self._draw(step, self.host_batch(),
                          self.seed + _process()[0] * 1_000_003)

    def global_batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The whole global batch ``step``, as one process draws it."""
        return self._draw(step, self.shape.global_batch, self.seed)

    def _draw(self, step: int, b: int, base: int) -> Dict[str, np.ndarray]:
        cfg, shp = self.cfg, self.shape
        s = shp.seq_len
        if cfg.family == "vision":
            emb = _philox(base, step, (b, s, cfg.d_model), 1000).astype(
                np.float32) / 500.0 - 1.0
            lbl = _philox(base + 7, step, (b,), cfg.vocab_size)
            return {"embeds": emb, "labels": lbl}
        if cfg.family == "audio":
            dec = max(s // 4, 8)
            emb = _philox(base, step, (b, s, cfg.d_model), 1000).astype(
                np.float32) / 500.0 - 1.0
            toks = _philox(base + 3, step, (b, dec + 1), cfg.vocab_size)
            return {"enc_embeds": emb, "dec_tokens": toks[:, :-1],
                    "labels": toks[:, 1:].copy()}
        if cfg.family == "vlm":
            emb = _philox(base, step, (b, s, cfg.d_model), 1000).astype(
                np.float32) / 500.0 - 1.0
            lbl = _philox(base + 3, step, (b, s), cfg.vocab_size)
            pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None, None],
                                  (3, b, s)).copy()
            return {"embeds": emb, "labels": lbl, "positions": pos}
        toks = _philox(base, step, (b, s + 1), cfg.vocab_size)
        return {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
