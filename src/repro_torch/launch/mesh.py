"""Meshes for one host — the counterpart of the reference's
``launch/mesh.py:make_host_mesh``, over processes instead of XLA host
devices.

:func:`make_host_mesh` names axes over an initialized ``torch.distributed``
group; :func:`local_mesh` keeps every shard in this process (the way the
reference's host mesh runs a ``shard_map``); :func:`spawn_ranks` starts
one process a rank, joins them in a gloo group (which takes CPU and CUDA
tensors, and any number of ranks on one card) through a ``file://``
rendezvous under a fresh temporary directory (no port to collide on when
several runs share a host), runs a function in each and returns what
each rank returned. Nothing here touches a device.
"""

from __future__ import annotations

import importlib
import math
import os
import tempfile
import time

import torch

from repro_torch.distributed.partitioning import Mesh


def make_host_mesh(shape=(2,), axes=("model",)) -> Mesh:
    """A mesh over the initialized default process group, whose size must
    be the mesh's."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialized process "
                           "group (spawn_ranks makes one)")
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} does not name axes {axes}")
    group = dist.group.WORLD
    if dist.get_world_size(group) != math.prod(shape):
        raise ValueError(f"a mesh of {shape} over "
                         f"{dist.get_world_size(group)} ranks")
    return Mesh(tuple(axes), dict(zip(axes, map(int, shape))), group)


def local_mesh(shape=(2,), axes=("model",)) -> Mesh:
    """A mesh whose every shard lives in this process."""
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} does not name axes {axes}")
    return Mesh(tuple(axes), dict(zip(axes, map(int, shape))), None)


def _rank_main(rank: int, target: str, world: int, tmp: str, args) -> None:
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            world_size=world, rank=rank)
    try:
        module, name = target.split(":")
        fn = getattr(importlib.import_module(module), name)
        result = fn(make_host_mesh((world,), ("model",)), *args)
        torch.save(result, os.path.join(tmp, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_ranks(target: str, world: int, args=(), *,
                timeout: float | None = None) -> list:
    """Run ``target`` ("module:function", importable in a fresh process)
    as ``fn(mesh, *args)`` in ``world`` processes, a 1-D ``("model",)``
    mesh over them; → each rank's return value, in rank order. A rank that
    raises stops the others and raises here; so does a run past
    ``timeout`` seconds. No rank outlives the call."""
    with tempfile.TemporaryDirectory() as tmp:
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(target, world, tmp, tuple(args)),
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
