"""Fault-tolerant checkpointing of the port, in the JAX package's format.

Atomic: written to ``<dir>/tmp.<step>.<pid>`` and renamed with
``os.replace`` to ``<dir>/step_<n>`` (8 digits), so a crash mid-save
never corrupts the latest checkpoint.  ``arrays.npz`` holds one array a
leaf; ``manifest.json`` the step, the keys, dtypes and shapes, and a
SHA-256 over each key and its array's bytes in key order, which
``restore`` checks.  ``CheckpointManager`` adds async saves (a
background thread) and keep-N retention.

A checkpoint written by either package restores in the other:
  * keys are JAX's: the tree path's entries joined by "/" -- a dict key,
    a list index, and for a NamedTuple field (``AdamWState``) its
    ``GetAttrKey`` string, ``.step``, ``.m``, ``.v``: ``opt/.m/embed/table``;
  * a ``stack`` or ``enc_stack`` list of per-group dicts (the port's
    layout) is written as JAX stacks it, one array per leaf with a
    leading ``num_groups`` axis, and split again on restore;
  * a bf16 tensor is written as numpy's 2-byte void (``|V2``) of its bit
    pattern, with ``"bfloat16"`` in the manifest, which is how
    ``np.savez`` stores a JAX bf16 leaf; the checksum covers the same raw
    bytes.  A ``|V2`` array is read back as bf16;
  * a Python scalar (``"data_step": 2``) is saved as a 0-d array and
    comes back as one (numpy), as in JAX.
There is no mesh, so no re-sharding on restore: each tensor goes to the
device of the ``tree_like`` leaf it replaces.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import tree as TR
from repro_torch.bridge import STACKS, tensor_from_numpy, tensor_to_numpy


def _is_stack(key, child) -> bool:
    """A ``stack``/``enc_stack`` list of per-group dicts."""
    return key in STACKS and isinstance(child, list) and bool(child) \
        and isinstance(child[0], dict)


def _entries(tree, path=()):
    """(key, leaf) pairs of ``tree`` in JAX's layout: a stack list yields
    one entry per leaf path holding the list of its groups' leaves."""
    if TR.is_leaf(tree):
        return [("/".join(path), tree)]
    out = []
    for k, c in TR.children(tree):
        name = f".{k}" if TR.is_namedtuple(tree) else str(k)
        if _is_stack(k, c):
            out += [(key, [TR.leaves(g)[i] for g in c])
                    for i, (key, _) in enumerate(_entries(c[0],
                                                          path + (name,)))]
        else:
            out += _entries(c, path + (name,))
    return out


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, list):               # a stack's groups
        return np.stack([_to_numpy(x) for x in leaf])
    if torch.is_tensor(leaf):
        return tensor_to_numpy(leaf)
    return np.asarray(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    """key -> host array, JAX's keys and layout."""
    return {k: _to_numpy(leaf) for k, leaf in _entries(tree)}


def _dtype_name(a: np.ndarray) -> str:
    return "bfloat16" if a.dtype == np.dtype("V2") else str(a.dtype)


def save(tree, directory: str, step: int) -> str:
    """Atomic synchronous save.  Returns the checkpoint path."""
    return _write(_flatten(tree), directory, step)


def _write(flat: Dict[str, np.ndarray], directory: str, step: int) -> str:
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp.{step}.{os.getpid()}")
    final = os.path.join(directory, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    h = hashlib.sha256()
    for k in sorted(flat):
        h.update(k.encode())
        h.update(flat[k].tobytes())
    manifest = {
        "step": step,
        "keys": sorted(flat.keys()),
        "dtypes": {k: _dtype_name(v) for k, v in flat.items()},
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "checksum": h.hexdigest(),
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_")]
    return max(steps) if steps else None


def _from_numpy(arr: np.ndarray, like):
    """A stored array in place of the ``tree_like`` leaf ``like``: a
    tensor on its device (bf16 from ``|V2``), or the array itself for a
    non-tensor leaf."""
    if torch.is_tensor(like):
        return tensor_from_numpy(arr, like.device)
    return arr


def restore(tree_like, directory: str, step: Optional[int] = None,
            validate: bool = True):
    """Restore into the structure of ``tree_like`` (the step's arrays,
    each leaf in its stored dtype).  Returns (tree, step)."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    # each array read once (an NpzFile re-reads its zip member on every
    # access), for the checksum and the restore alike
    with np.load(os.path.join(path, "arrays.npz")) as npz:
        data = {k: npz[k] for k in manifest["keys"]}
    if validate:
        h = hashlib.sha256()
        for k in sorted(manifest["keys"]):
            h.update(k.encode())
            h.update(data[k].tobytes())
        if h.hexdigest() != manifest["checksum"]:
            raise IOError(f"checkpoint {path} checksum mismatch")
    out = []
    for key, like in _entries(tree_like):
        arr = data[key]
        if isinstance(like, list):           # split a stack into groups
            out.append([_from_numpy(arr[g], x) for g, x in enumerate(like)])
        else:
            out.append(_from_numpy(arr, like))
    return _rebuild(tree_like, out), step


def _rebuild(tree_like, values):
    """``tree_like`` with its ``_entries`` replaced by ``values`` (for a
    stack entry, the list of its groups' new leaves)."""
    it = iter(values)

    def walk(tree):
        if tree is None:
            return None
        if TR.is_leaf(tree):
            return next(it)
        kids = TR.children(tree)
        new = {}
        for k, c in kids:
            if _is_stack(k, c):
                per_leaf = [next(it) for _ in TR.leaves(c[0])]
                new[k] = [TR.unflatten_like(g, iter(col[i]
                                                     for col in per_leaf))
                          for i, g in enumerate(c)]
            else:
                new[k] = walk(c)
        if isinstance(tree, dict):
            return {k: new[k] for k in tree}
        items = [new[k] for k, _ in kids]
        if TR.is_namedtuple(tree):
            return type(tree)(*items)
        return type(tree)(items)
    return walk(tree_like)


class CheckpointManager:
    """Async + retention on top of save/restore."""

    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None

    def save(self, tree, step: int):
        # snapshot to host first so that later updates cannot race the
        # writer
        host = _flatten(tree)
        if self._thread is not None:
            self._thread.join()
        if self.async_save:
            self._thread = threading.Thread(
                target=self._save_and_gc, args=(host, step), daemon=True)
            self._thread.start()
        else:
            self._save_and_gc(host, step)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore_latest(self, tree_like):
        return restore(tree_like, self.directory)

    def _save_and_gc(self, flat, step: int):
        _write(flat, self.directory, step)
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.directory)
                       if d.startswith("step_"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
