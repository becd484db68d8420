"""Bring the JAX package's weights across to the port.

``params_from_numpy(tree, cfg, device)`` takes the JAX param pytree as
nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)``) and
returns the port's params: each stack's leading ``num_groups`` axis
(``stack``, and whisper's ``enc_stack``) is split into one dict per
group, and every other leaf is copied as is (the ViTs' ``cls`` and
``pos_embed``, whisper's ``enc_norm``; the cross-attention blocks'
``norm_x`` and ``cross`` ride inside their stack's groups).
bf16 stays exact: an array whose dtype is named "bfloat16" is moved as
its 16-bit pattern and viewed back as ``torch.bfloat16`` (no ml_dtypes
needed).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


STACKS = ("stack", "enc_stack")


def params_from_numpy(tree, cfg: ModelConfig, device="cuda"):
    """JAX params (numpy leaves) -> the port's params on ``device``."""
    out = {k: _map(v, lambda a: tensor_from_numpy(a, device))
           for k, v in tree.items() if k not in STACKS}
    for name in STACKS:
        if name in tree:
            out[name] = [_map(tree[name],
                              lambda a, g=g: tensor_from_numpy(
                                  np.asarray(a)[g], device))
                         for g in range(cfg.num_groups)]
    return out
