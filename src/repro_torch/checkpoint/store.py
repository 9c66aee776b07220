"""Sharded checkpoint store, the reference's ``checkpoint/store.py``
layout, so either side reads the other's files:

    <dir>/step_<N>/proc_<i>.npz      one shard per host process
    <dir>/step_<N>/manifest.json     written last: a step directory
                                     without a manifest is garbage

Shards land in ``step_<N>.tmp/``, the manifest is written inside it, and
the directory is renamed into place (the atomic commit); a crash mid-save
leaves a ``.tmp`` directory that restore ignores and the next save
overwrites. The npz keys are ``a<i>`` in the reference's leaf order and
the manifest lists each leaf's ``keystr`` path (``['layers']['attn']
['wq']['w']``, ``[1].m[...]``), which a restore checks against the
structure it is given, as it checks every shape.
"""

from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np
import torch

from repro_torch.tree_util import flatten_with_path, unflatten


def _numpy(v) -> np.ndarray:
    if torch.is_tensor(v):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_checkpoint(ckpt_dir: str, step: int, tree, *, extra: dict | None
                    = None, process_index: int = 0, process_count: int = 1,
                    keep: int = 3) -> str:
    """Save ``tree`` (nested dicts, tuples and NamedTuples of tensors or
    arrays) for ``step``, keeping the newest ``keep`` steps. → the step's
    path."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    flat = flatten_with_path(tree)
    np.savez(os.path.join(tmp, f"proc_{process_index}.npz"),
             **{f"a{i}": _numpy(v) for i, (_, v) in enumerate(flat)})
    if process_index == 0:
        manifest = {"step": step, "keys": [k for k, _ in flat],
                    "process_count": process_count, "time": time.time(),
                    "extra": extra or {}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                       # the atomic commit
        _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    for s in sorted(_list_steps(ckpt_dir))[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def _list_steps(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    return [int(name[5:]) for name in os.listdir(ckpt_dir)
            if name.startswith("step_") and not name.endswith(".tmp")
            and os.path.exists(os.path.join(ckpt_dir, name,
                                            "manifest.json"))]


def latest_step(ckpt_dir: str) -> int | None:
    steps = _list_steps(ckpt_dir)
    return max(steps) if steps else None


def load_checkpoint(ckpt_dir: str, tree_like, *, step: int | None = None,
                    process_index: int = 0):
    """Restore into the structure of ``tree_like``: each leaf a tensor on
    its ``tree_like`` leaf's device (a numpy array where that leaf is
    not a tensor), bitwise what was saved. Raises ValueError on another
    structure or shape, FileNotFoundError when no step is complete. →
    (tree, step, extra)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = flatten_with_path(tree_like)
    keys = [k for k, _ in flat]
    if manifest["keys"] != keys:
        raise ValueError("checkpoint/model structure mismatch: "
                         f"{set(manifest['keys']) ^ set(keys)}")
    data = np.load(os.path.join(path, f"proc_{process_index}.npz"))
    out = []
    for i, (k, like) in enumerate(flat):
        arr = data[f"a{i}"]
        if hasattr(like, "shape") and tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"shape mismatch for {k}: "
                             f"{arr.shape} vs {tuple(like.shape)}")
        out.append(torch.from_numpy(np.array(arr)).to(like.device)
                   if torch.is_tensor(like) else arr)
    return unflatten(tree_like, out), step, manifest["extra"]
