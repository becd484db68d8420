"""Bring the JAX package's weights across to the port.

``params_from_numpy(tree, cfg, device)`` takes the JAX param pytree as
nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)``) and
returns the port's params: the stack's leading ``num_groups`` axis is
split into one dict per group, and every other leaf is copied as is.
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


def params_from_numpy(tree, cfg: ModelConfig, device="cuda"):
    """JAX params (numpy leaves) -> the port's params on ``device``."""
    out = {k: _map(v, lambda a: tensor_from_numpy(a, device))
           for k, v in tree.items() if k != "stack"}
    out["stack"] = [_map(tree["stack"],
                         lambda a, g=g: tensor_from_numpy(np.asarray(a)[g],
                                                          device))
                    for g in range(cfg.num_groups)]
    return out
