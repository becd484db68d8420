"""Carry weights and optimizer state between the JAX package and the port.

``params_from_numpy(tree, cfg, device)`` takes the JAX param pytree as
nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)``) and
returns the port's params: each stack's leading ``num_groups`` axis
(``stack``, and whisper's ``enc_stack``) is split into one dict per
group, and every other leaf is copied as is (the ViTs' ``cls`` and
``pos_embed``, whisper's ``enc_norm``; the cross-attention blocks'
``norm_x`` and ``cross`` ride inside their stack's groups).
bf16 stays exact: an array whose dtype is named "bfloat16", or a 2-byte
void (``|V2``, how ``np.savez`` stores a JAX bf16 array), is moved as
its 16-bit pattern and viewed back as ``torch.bfloat16`` (no ml_dtypes
needed).

``params_to_numpy`` is the inverse: the port's params as JAX's layout of
numpy arrays (the groups restacked; a bf16 tensor as ``|V2`` bits, which
``.view(ml_dtypes.bfloat16)`` turns into JAX's dtype).
``opt_state_to_numpy``/``opt_state_from_numpy`` do the same for AdamW's
(step, m, v).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


BF16_BITS = np.dtype("V2")


def tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.array(a, order="C")       # a C-ordered copy; 0-d stays 0-d
    if a.dtype.name == "bfloat16" or a.dtype == BF16_BITS:
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t``; bf16 as ``|V2`` of its bit pattern."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_BITS)
    return t.numpy()


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


def params_to_numpy(params):
    """The port's params -> JAX's layout as nested dicts of numpy arrays:
    each ``stack``/``enc_stack`` list of groups stacked on a leading axis
    (the inverse of ``params_from_numpy``)."""
    out = {k: _map(v, tensor_to_numpy) for k, v in params.items()
           if k not in STACKS}
    for name in STACKS:
        if name in params:
            out[name] = _restack(params[name])
    return out


def _restack(groups):
    if isinstance(groups[0], dict):
        return {k: _restack([g[k] for g in groups]) for k in groups[0]}
    return np.stack([tensor_to_numpy(t) for t in groups])


def opt_state_to_numpy(state):
    """The port's ``AdamWState`` -> (step, m, v) of numpy arrays in JAX's
    layout (``repro.training.AdamWState(*...)`` takes them)."""
    return (tensor_to_numpy(state.step), params_to_numpy(state.m),
            params_to_numpy(state.v))


def opt_state_from_numpy(state, cfg: ModelConfig, device="cuda"):
    """JAX's AdamW state ((step, m, v), numpy leaves, a NamedTuple too)
    -> the port's ``AdamWState`` on ``device``."""
    from repro_torch.training.optimizer import AdamWState
    step, m, v = state
    return AdamWState(step=tensor_from_numpy(step, device),
                      m=params_from_numpy(m, cfg, device),
                      v=params_from_numpy(v, cfg, device))
