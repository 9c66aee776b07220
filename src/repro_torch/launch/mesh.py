"""Meshes for one host — the counterpart of the reference's
``launch/mesh.py:make_host_mesh``, over processes instead of XLA host
devices.

:func:`make_host_mesh` names axes over an initialized ``torch.distributed``
group; :func:`local_mesh` keeps every shard in this process (the way the
reference's host mesh runs a ``shard_map``); :func:`spawn_ranks` starts
one process a rank, joins them in a gloo group (which takes CPU and CUDA
tensors, and any number of ranks on one card) through a ``file://``
rendezvous under a fresh temporary directory (no port to collide on when
several runs share a host), builds a mesh of any shape over them, runs a
function in each and returns what each rank returned.
:func:`make_production_mesh` is the reference's production mesh as one
rank's abstract view (:func:`abstract_mesh`), which the dry-run traces
on meta tensors. Nothing here touches a device.
"""

from __future__ import annotations

import importlib
import itertools
import math
import os
import tempfile
import time

import torch

from repro_torch.distributed.partitioning import Mesh, slice_ranks


def make_host_mesh(shape=(2,), axes=("model",), ranks=None) -> Mesh:
    """A mesh over the initialized default process group: over its first
    ``prod(shape)`` ranks, or over ``ranks`` (sorted), row-major. Every
    rank of the default group must call it, in the same order of calls:
    it makes the mesh's group and one subgroup for each slice of each
    proper subset of its axes (``dist.new_group`` is collective). A rank
    outside the mesh gets None."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialized process "
                           "group (spawn_ranks makes one)")
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} does not name axes {axes}")
    world = dist.get_world_size()
    n = math.prod(shape)
    ranks = tuple(sorted(range(world) if ranks is None else ranks))[:n]
    if len(ranks) != n or not all(0 <= r < world for r in ranks):
        raise ValueError(f"a mesh of {shape} over ranks {ranks} of a "
                         f"world of {world}")
    sizes = dict(zip(axes, map(int, shape)))
    group = dist.group.WORLD if n == world else dist.new_group(list(ranks))
    me = dist.get_rank()
    subgroups = {}
    for k in range(1, len(axes)):
        for sub in itertools.combinations(axes, k):
            if math.prod(sizes[a] for a in sub) == 1:
                continue
            for members in slice_ranks(tuple(axes), sizes, ranks, sub):
                g = dist.new_group(members)
                if me in members:
                    subgroups[sub] = g
    if me not in ranks:
        return None
    return Mesh(tuple(axes), sizes, group, subgroups)


def local_mesh(shape=(2,), axes=("model",)) -> Mesh:
    """A mesh whose every shard lives in this process."""
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} does not name axes {axes}")
    return Mesh(tuple(axes), dict(zip(axes, map(int, shape))), None)


def abstract_mesh(shape, axes, coords: dict | None = None) -> Mesh:
    """One rank's view of a mesh of ``shape`` over ``axes``: the rank at
    ``coords`` (axis → coordinate; all 0 by default), no process group;
    its collectives take meta tensors only
    (:mod:`repro_torch.distributed.partitioning`)."""
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} does not name axes {axes}")
    sizes = dict(zip(axes, map(int, shape)))
    at = {a: 0 for a in axes} if coords is None else {
        a: int(coords[a]) for a in axes}
    if any(not 0 <= at[a] < sizes[a] for a in axes):
        raise ValueError(f"coordinates {at} outside the mesh {sizes}")
    return Mesh(tuple(axes), sizes, at=at)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh as rank 0's abstract view: 16 × 16
    = 256 ranks over ("data", "model") (``pod16x16``), or 2 × 16 × 16 =
    512 over ("pod", "data", "model") (``pod2x16x16``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return abstract_mesh(shape, axes)


def _rank_main(rank: int, target: str, world: int, tmp: str, args,
               shape, axes) -> None:
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            world_size=world, rank=rank)
    try:
        module, name = target.split(":")
        fn = getattr(importlib.import_module(module), name)
        result = fn(make_host_mesh(shape, axes), *args)
        torch.save(result, os.path.join(tmp, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_ranks(target: str, world: int, args=(), *, shape=None,
                axes=("model",), timeout: float | None = None) -> list:
    """Run ``target`` ("module:function", importable in a fresh process)
    as ``fn(mesh, *args)`` in ``world`` processes, ``mesh`` the mesh of
    ``shape`` (default ``(world,)``) over axes ``axes`` built over them
    (None on a rank past ``prod(shape)``); → each rank's return value, in
    rank order. A rank that raises stops the others and raises here; so
    does a run past ``timeout`` seconds. No rank outlives the call."""
    shape = (world,) if shape is None else tuple(shape)
    with tempfile.TemporaryDirectory() as tmp:
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(target, world, tmp, tuple(args), shape,
                              tuple(axes)),
            nprocs=world, join=False, start_method="spawn")
        end = None if timeout is None else time.monotonic() + timeout
        try:
            while not ctx.join(None if end is None
                               else max(end - time.monotonic(), 0.0)):
                if end is not None and time.monotonic() >= end:
                    raise TimeoutError(f"{target}: {world} ranks still "
                                       f"running after {timeout} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.terminate()
                proc.join()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
