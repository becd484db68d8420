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

Sharded trees (DTensors in JAX's stacked layout, ``sharding.shard_tree``):
``save`` gathers one leaf at a time to its full array (a collective:
every rank calls it) and rank 0 copies it to host memory before the
next, so no device holds more than one gathered leaf; rank 0 writes the
same format, and the ranks wait for the write.  ``restore(..., shardings=)`` re-shards onto the current mesh,
which may differ from the saving one (elastic restart) or be none; each
tensor first goes to the device of the ``tree_like`` leaf it replaces.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import shutil
import struct
import threading
import zipfile
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


def _bytes(a: np.ndarray):
    """``a``'s bytes in C order, as ``tobytes`` gives them, without a
    copy when ``a`` is contiguous (the checksum reads gigabytes)."""
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _dtype_name(a: np.ndarray) -> str:
    return "bfloat16" if a.dtype == np.dtype("V2") else str(a.dtype)


def _host_arrays(tree):
    """(key -> host array, JAX's keys and layout; sharded).  A sharded
    tree (DTensor leaves) is gathered a leaf at a time, a collective that
    every rank calls: rank 0 copies each full leaf to host memory and
    drops it before the next, so a device holds one gathered leaf at a
    time, and the other ranks get None."""
    from torch.distributed.tensor import DTensor
    entries = _entries(tree)
    if not any(isinstance(t, DTensor) for _, t in entries):
        return _flatten(tree), False
    from repro_torch.sharding.collectives import is_writer
    from repro_torch.sharding.execute import gather_leaf
    writer = is_writer()
    out = {}
    for key, t in entries:
        full = gather_leaf(t)
        if writer:
            out[key] = _to_numpy(full)
        del full
    return (out if writer else None), True


def save(tree, directory: str, step: int) -> str:
    """Atomic synchronous save.  Returns the checkpoint path.  A sharded
    tree is gathered a leaf at a time, written by rank 0, and every rank
    returns once the write is done."""
    from repro_torch.sharding.collectives import barrier
    flat, sharded = _host_arrays(tree)
    final = os.path.join(directory, f"step_{step:08d}")
    if flat is not None:
        final = _write(flat, directory, step)
    if sharded:
        barrier()
    return final


def _write(flat: Dict[str, np.ndarray], directory: str, step: int) -> str:
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp.{step}.{os.getpid()}")
    final = os.path.join(directory, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    h = hashlib.sha256()

    def digest():
        for k in sorted(flat):
            h.update(k.encode())
            h.update(_bytes(flat[k]))
    # hashlib and the file writes release the GIL: the checksum is taken
    # while the arrays are written
    hasher = threading.Thread(target=digest)
    hasher.start()
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    hasher.join()
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


_HEADERS = {(1, 0): np.lib.format.read_array_header_1_0,
            (2, 0): np.lib.format.read_array_header_2_0}


def _read_arrays(path: str, keys) -> Dict[str, np.ndarray]:
    """Each array of an ``np.savez`` file, read once (for the checksum and
    the restore alike).  A stored (uncompressed) member, as both packages
    write them, is read straight from its offset in the file into its
    array, without zipfile's chunked copy and CRC (the manifest's
    SHA-256 is the check); any other member goes through numpy's
    reader."""
    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for k in keys:
            info = zf.getinfo(k + ".npy")
            if info.compress_type == zipfile.ZIP_STORED:
                # the member's local header: 30 bytes, then its name and
                # extra field, then the .npy file
                f.seek(info.header_offset + 26)
                name, extra = struct.unpack("<HH", f.read(4))
                f.seek(info.header_offset + 30 + name + extra)
                version = np.lib.format.read_magic(f)
                if version in _HEADERS:
                    shape, fortran, dtype = _HEADERS[version](f)
                    if not dtype.hasobject:
                        a = np.fromfile(f, dtype=dtype,
                                        count=math.prod(shape))
                        out[k] = (a.reshape(shape[::-1]).T if fortran
                                  else a.reshape(shape))
                        continue
            with zf.open(info) as member:
                out[k] = np.lib.format.read_array(member)
    return out


def restore(tree_like, directory: str, step: Optional[int] = None,
            shardings=None, validate: bool = True):
    """Restore into the structure of ``tree_like`` (the step's arrays,
    each leaf in its stored dtype).  Returns (tree, step).

    shardings: None (full tensors), or the placements to re-shard onto,
    as a ``(spec_tree, DeviceMesh)`` pair for a tree of params (specs in
    JAX's stacked layout, ``sharding.param_specs``), or a tree of
    ``(DeviceMesh, placements)`` leaves in the stacked layout; a dict or
    NamedTuple may mix them and hold None for a part to keep full (JAX's
    launcher passes ``{"params": ..., "opt": None}``).  A re-sharded part
    comes back as DTensors in the stacked layout."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = _read_arrays(os.path.join(path, "arrays.npz"), manifest["keys"])
    if validate:
        h = hashlib.sha256()
        for k in sorted(manifest["keys"]):
            h.update(k.encode())
            h.update(_bytes(data[k]))
        if h.hexdigest() != manifest["checksum"]:
            raise IOError(f"checkpoint {path} checksum mismatch")
    out = []
    for key, like in _entries(tree_like):
        arr = data[key]
        if isinstance(like, list):           # split a stack into groups
            out.append([_from_numpy(arr[g], x) for g, x in enumerate(like)])
        else:
            out.append(_from_numpy(arr, like))
    tree = _rebuild(tree_like, out)
    if shardings is not None:
        tree = _reshard(tree, shardings)
    return tree, step


def _reshard(tree, sh):
    """``tree`` re-sharded by ``sh`` (see ``restore``)."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.sharding.execute import shard_tree, stacked
    if sh is None:
        return tree
    if isinstance(sh, tuple) and not TR.is_namedtuple(sh) and len(sh) == 2:
        if isinstance(sh[1], DeviceMesh):
            return shard_tree(tree, sh[0], sh[1])
        if isinstance(sh[0], DeviceMesh):
            return distribute_tensor(tree, sh[0], sh[1], src_data_rank=None)
    if TR.is_namedtuple(sh):
        return type(tree)(*(_reshard(t, s) for t, s in zip(tree, sh)))
    if isinstance(sh, dict):
        out = dict(tree)
        for k, s in sh.items():
            v = tree[k]
            if isinstance(s, dict) and isinstance(v, list):
                v = stacked({k: v})[k]       # per-leaf pairs: stacked
            out[k] = _reshard(v, s)
        return out
    raise TypeError(f"shardings: cannot read {type(sh).__name__}")


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
        self._sharded = False

    def save(self, tree, step: int):
        # snapshot to host first so that later updates cannot race the
        # writer; a sharded tree is gathered (every rank calls save) and
        # rank 0 writes it
        host, sharded = _host_arrays(tree)
        self._sharded = self._sharded or sharded
        if self._thread is not None:
            self._thread.join()
        if host is None:
            return
        if self.async_save:
            self._thread = threading.Thread(
                target=self._save_and_gc, args=(host, step), daemon=True)
            self._thread.start()
        else:
            self._save_and_gc(host, step)

    def wait(self):
        """Until the last save is written (on every rank, for a sharded
        tree)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._sharded:
            from repro_torch.sharding.collectives import barrier
            barrier()
            self._sharded = False

    def restore_latest(self, tree_like, shardings=None):
        return restore(tree_like, self.directory, shardings=shardings)

    def _save_and_gc(self, flat, step: int):
        _write(flat, self.directory, step)
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.directory)
                       if d.startswith("step_"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
