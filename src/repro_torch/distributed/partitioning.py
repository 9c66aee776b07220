"""Named mesh axes and the collectives over them — the counterpart of the
reference's ``distributed/partitioning.py`` for the axes the serving path
shards over.

A :class:`Mesh` names axes over ranks laid out row-major. It runs in one
of two ways, chosen when it is built (:mod:`repro_torch.launch.mesh`):

* over a ``torch.distributed`` process group, one rank a process: each
  process holds its own shard, :meth:`Mesh.rank` is its index along an
  axis, and :func:`pmax` / :func:`psum` are ``all_reduce`` MAX / SUM;
* in one process (``group`` None), as a JAX host mesh runs every shard
  of a ``shard_map`` in one program: the caller loops over the shards
  and stacks their values on a leading axis, which :func:`pmax` and
  :func:`psum` reduce (keeping it, at size 1).

``shard`` is the identity: in the reference it is a sharding annotation
for XLA, not a computation. The data and pod axes are not used by any
path of the port (one card a host).
"""

from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

_state = threading.local()


@dataclass(eq=False)
class Mesh:
    """Axes ``axis_names`` of sizes ``shape`` over the ranks of ``group``
    (a ``torch.distributed`` process group; ``None`` for every shard in
    this process)."""
    axis_names: tuple
    shape: dict = field(default_factory=dict)
    group: object | None = None

    @property
    def local(self) -> bool:
        """Whether every shard of the mesh lives in this process."""
        return self.group is None

    def size(self, axes) -> int:
        return math.prod(int(self.shape[a]) for a in _axes(axes))

    def rank(self, axes) -> int:
        """This process's index along ``axes`` (row-major over them)."""
        if self.local:
            raise ValueError("a single-process mesh has no rank: loop over "
                             "its shards")
        import torch.distributed as dist
        coord, r = {}, dist.get_rank(self.group)
        for a in reversed(self.axis_names):
            coord[a] = r % int(self.shape[a])
            r //= int(self.shape[a])
        idx = 0
        for a in _axes(axes):
            idx = idx * int(self.shape[a]) + coord[a]
        return idx


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def current_mesh() -> Mesh | None:
    return getattr(_state, "mesh", None)


@contextmanager
def use_mesh(mesh: Mesh | None):
    """Make ``mesh`` the current mesh for the scope."""
    prev = current_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def dp_axes(mesh: Mesh | None = None) -> tuple:
    mesh = mesh or current_mesh()
    if mesh is not None and "pod" in mesh.axis_names:
        return ("pod", "data")
    return ("data",)


def shard(x: torch.Tensor, *axes) -> torch.Tensor:
    """The reference's sharding constraint: the identity here."""
    del axes
    return x


def _reduce(x: torch.Tensor, axes, mesh: Mesh | None, op: str):
    mesh = mesh or current_mesh()
    if mesh is None:
        raise ValueError(f"p{op} needs an active mesh")
    if mesh.local:
        # shards stacked on axis 0; summed in shard order
        return x.amax(0, keepdim=True) if op == "max" else x.sum(
            0, keepdim=True)
    if set(_axes(axes)) != set(mesh.axis_names):
        raise NotImplementedError(
            f"collectives over {_axes(axes)} of a mesh with axes "
            f"{mesh.axis_names}: only over every axis")
    import torch.distributed as dist
    y = x.contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=mesh.group)
    return y


def pmax(x: torch.Tensor, axes, mesh: Mesh | None = None) -> torch.Tensor:
    """Elementwise max over the shards along ``axes``."""
    return _reduce(x, axes, mesh, "max")


def psum(x: torch.Tensor, axes, mesh: Mesh | None = None) -> torch.Tensor:
    """Elementwise sum over the shards along ``axes``."""
    return _reduce(x, axes, mesh, "sum")
