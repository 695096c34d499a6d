"""Checkpoints of the port (counterpart of the JAX package's
``train/checkpoint.py``), in the same on-disk format, so a checkpoint
written by either package restores in the other bit-exact.

Layout: <dir>/step_<N>/
    manifest.json          {"step": N, "leaves": [{"path", "dtype",
                            "shape"}, ...]} in sorted-key path order
    <flat-index>.npy       one file per leaf, in that order

A bfloat16 leaf is stored as its uint16 bits with dtype "bfloat16" (numpy
has no bfloat16; ``bridge`` converts both ways, without ``ml_dtypes``).
A step is written to ``step_<N>.tmp`` and renamed, so a crash mid-write
leaves no ``step_<N>`` behind; only the newest ``keep`` steps are kept.

A state sharded over a mesh (one tree a shard, laid out by a
``launch.sharding.TreeSharding``) is saved with ``shardings=``: each leaf
is gathered whole on the host first, as the reference's ``device_get``
does, so its files are byte-identical to those of the same state saved
from one device. ``restore_checkpoint(..., shardings=)`` is the elastic
restore: each leaf comes back as its shards' blocks on their devices,
on whatever mesh the layout names.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import bridge
from ..launch import mesh as mesh_lib
from ..launch.sharding import unshard_leaf

Pytree = Any

_SAFE = re.compile(r"step_(\d+)$")


def _paths(tree: Pytree, prefix=()) -> List:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_paths(tree[k], prefix + (k,)))
        return out
    return [(prefix, tree)]


def _set_path(d: Dict, path, val) -> None:
    for k in path[:-1]:
        d = d.setdefault(k, {})
    d[path[-1]] = val


def save_checkpoint(ckpt_dir: str, state: Pytree, step: int,
                    keep: int = 3, shardings=None) -> str:
    """Write ``state`` (nested dicts of tensors; with ``shardings``, a
    ``TreeSharding``, one such tree a shard) as step ``step``; prunes
    all but the newest ``keep`` steps. Returns the step's directory."""
    out = os.path.join(ckpt_dir, f"step_{step}")
    tmp = out + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = []
    tree = state[0] if shardings is not None else state
    for i, (path, leaf) in enumerate(_paths(tree)):
        if shardings is not None:         # gathered whole on the host
            leaf = unshard_leaf(state, path, shardings.pspec(path),
                                shardings.mesh, "cpu")
        arr = bridge.tree_to_numpy(leaf)
        dtype = ("bfloat16" if leaf.dtype == torch.bfloat16
                 else str(arr.dtype))
        np.save(os.path.join(tmp, f"{i}.npy"), arr)
        manifest.append({"path": list(path), "dtype": dtype,
                         "shape": list(arr.shape)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "leaves": manifest}, f)
    if os.path.exists(out):
        shutil.rmtree(out)
    os.rename(tmp, out)
    for s in all_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"),
                      ignore_errors=True)
    return out


def all_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = _SAFE.match(name)
        if m and os.path.exists(os.path.join(ckpt_dir, name,
                                             "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, step: Optional[int] = None,
                       device=None, shardings=None) -> Pytree:
    """Load step ``step`` (the latest when None) as nested dicts of
    tensors on ``device`` (default the card; it raises where there is
    none). With ``shardings`` (a ``TreeSharding``: a mesh and a tree of
    PartitionSpecs, a path it lacks replicated) it returns one such tree
    a shard, each leaf the shard's block on its device: the elastic
    restore onto the current mesh."""
    if shardings is None:
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to "
                               "restore onto the CPU")
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    n = 1 if shardings is None else shardings.mesh.size
    states: List[Dict] = [{} for _ in range(n)]
    for i, meta in enumerate(manifest["leaves"]):
        arr = np.load(os.path.join(d, f"{i}.npy"))
        if meta["dtype"] != "bfloat16":        # bfloat16: the uint16 bits
            arr = arr.view(np.dtype(meta["dtype"]))
        path = tuple(meta["path"])
        if shardings is None:
            _set_path(states[0], path, bridge.tree_from_numpy(arr, device))
            continue
        whole = bridge.tree_from_numpy(arr, "cpu")
        ps = shardings.pspec(path)
        for s in range(n):
            _set_path(states[s], path,
                      mesh_lib.piece(whole, ps, shardings.mesh, s))
    return states[0] if shardings is None else states
