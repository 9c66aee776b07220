"""Named mesh axes, the logical axes resolved against them, and the
collectives over any subset of a mesh's axes — the counterpart of the
reference's ``distributed/partitioning.py``.

Model code names *logical* axes, resolved against the active mesh:

  ``dp``    data parallel, the batch dim: ``("data",)``, or ``("pod",
            "data")`` on a mesh with a pod axis;
  ``fsdp``  parameter and optimizer sharding, the same mesh axes as ``dp``;
  ``tp``    tensor parallel, ``"model"``: heads, the FFN hidden, vocab;
  ``ep``    expert parallel, ``"model"``;
  ``sp``    sequence parallel, ``"model"``: the decode cache's token axis.

A :class:`Mesh` names axes over ranks laid out row-major. It runs in one
of three ways, chosen when it is built (:mod:`repro_torch.launch.mesh`):

* over a ``torch.distributed`` process group, one rank a process: each
  process holds its own shard and :meth:`Mesh.rank` is its index along
  axes. The mesh holds one subgroup for each slice of each proper subset
  of its axes (made once, when it is built), and a collective over
  ``axes`` runs in this rank's slice;
* in one process (``group`` None), as a JAX host mesh runs every shard
  of a ``shard_map`` in one program: a value's leading dims are the
  mesh's axes, in order (size 1 along an axis where every rank holds the
  same value), and a collective maps them as the ranks would;
* abstract (``at`` the coordinates of one rank, all 0 by default): one
  rank's view of a mesh of any size (the dry-run's 256 or 512 ranks),
  with no process group and no other rank. It takes ``meta`` tensors
  only — a real value would go through a collective that moves nothing —
  and each collective returns a meta tensor of the shape and dtype the
  rank would receive, recording ``(kind, result bytes)`` in the active
  :class:`repro_torch.analysis.op_trace.OpTrace` under the reference's
  kind names (``psum``/``pmax`` all-reduce, ``all_gather`` all-gather,
  ``psum_scatter`` reduce-scatter, ``all_to_all`` all-to-all,
  ``ppermute`` collective-permute). A collective over axes of size 1
  moves nothing and records nothing.

On a process group the reductions are ``all_reduce``s (or
``reduce_scatter_tensor``s), the gathers ``all_gather``s and the
all-to-alls one ``all_to_all_single``, which gloo takes on CUDA
tensors. A ring hop (:func:`ppermute`) pairs an
``isend`` with an ``irecv``, never blocking sends in a cycle; gloo's
point-to-point ops take host tensors only, so a CUDA tensor's hop runs
on an explicit host copy (the compute stays on the card; the copy is
the transport).

``shard`` is the identity: in the reference it is a sharding annotation
for XLA, not a computation.
"""

from __future__ import annotations

import itertools
import math
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

_state = threading.local()

# the collectives gloo runs on CUDA tensors; the others go through host
# copies (tests/test_torch_gpu.py::test_gloo_cuda_collectives_probe: on
# an H100 with torch 2.11 gloo also takes broadcast and
# all_gather_into_tensor; list all_to_all it takes on no device, and a
# send or recv of a CUDA tensor raises)
GLOO_CUDA_OPS = frozenset({"all_reduce", "all_gather", "all_to_all_single",
                           "reduce_scatter_tensor"})


@dataclass(eq=False)
class Mesh:
    """Axes ``axis_names`` of sizes ``shape`` over the ranks of ``group``
    (a ``torch.distributed`` process group; ``None`` for every shard in
    this process). ``subgroups`` maps a proper subset of the axes (in
    mesh order) to this rank's slice group. ``at`` (axis → coordinate)
    makes the mesh abstract: the one rank at ``at``, no group."""
    axis_names: tuple
    shape: dict = field(default_factory=dict)
    group: object | None = None
    subgroups: dict = field(default_factory=dict)
    at: dict | None = None

    @property
    def abstract(self) -> bool:
        """Whether the mesh is one rank's view, traced on meta tensors."""
        return self.at is not None

    @property
    def local(self) -> bool:
        """Whether every shard of the mesh lives in this process."""
        return self.group is None and self.at is None

    def size(self, axes) -> int:
        return math.prod(int(self.shape[a]) for a in _axes(axes))

    def coords(self) -> dict:
        """This process's coordinate along each axis."""
        if self.local:
            raise ValueError("a single-process mesh has no rank: loop over "
                             "its shards")
        if self.abstract:
            return dict(self.at)
        import torch.distributed as dist
        coord, r = {}, dist.get_rank(self.group)
        for a in reversed(self.axis_names):
            coord[a] = r % int(self.shape[a])
            r //= int(self.shape[a])
        return coord

    def rank(self, axes) -> int:
        """This process's index along ``axes`` (row-major over them)."""
        coord, idx = self.coords(), 0
        for a in _axes(axes):
            idx = idx * int(self.shape[a]) + coord[a]
        return idx

    def ordered(self, axes) -> tuple:
        """``axes`` in the mesh's order (unknown names raise)."""
        axes = _axes(axes)
        for a in axes:
            if a not in self.axis_names:
                raise ValueError(f"axis {a!r} is not one of "
                                 f"{self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def group_of(self, axes):
        """This rank's process group over ``axes`` (None when the slice is
        this rank alone)."""
        axes = self.ordered(axes)
        if self.size(axes) == 1:
            return None
        if axes == self.axis_names:
            return self.group
        return self.subgroups[axes]


def slice_ranks(axis_names: tuple, shape: dict, ranks: tuple, axes: tuple):
    """The mesh slices over ``axes`` (the other axes fixed): for each, the
    ``ranks`` of its positions, row-major over ``axes``."""
    strides, s = {}, 1
    for a in reversed(axis_names):
        strides[a] = s
        s *= int(shape[a])
    others = [a for a in axis_names if a not in axes]

    def positions(names):
        out = [0]
        for a in names:
            out = [p + c * strides[a] for p in out
                   for c in range(int(shape[a]))]
        return out
    return [[ranks[base + off] for off in positions(axes)]
            for base in positions(others)]


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


def resolve_axis(logical, mesh: Mesh | None = None):
    """A logical axis name (or None, or raw mesh axes) → mesh axes."""
    if logical is None:
        return None
    if logical in ("dp", "fsdp"):
        return dp_axes(mesh)
    if logical in ("tp", "ep", "sp"):
        return "model"
    return logical


def logical_to_spec(axes: tuple, mesh: Mesh | None = None) -> tuple:
    """("fsdp", "tp") → (("data",), "model") etc."""
    mesh = mesh or current_mesh()
    return tuple(resolve_axis(a, mesh) for a in axes)


def leaf_dims(spec: tuple, shape, mesh: Mesh) -> tuple:
    """A leaf's sharding on ``mesh``: for each dim the mesh axes it is cut
    over (a tuple, in mesh order) or None. A logical spec names leading
    dims (the rest replicated); an axis the mesh lacks, or whose size does
    not divide the dim, drops to replicated (the reference's
    ``launch/dryrun.py:_shardings`` rule)."""
    spec = tuple(logical_to_spec(spec, mesh)) + (None,) * (
        len(shape) - len(spec))
    dims = []
    for n, entry in zip(shape, spec[:len(shape)]):
        axes = tuple(a for a in (entry,) if a is not None) \
            if isinstance(entry, str) or entry is None else tuple(entry)
        if not axes or any(a not in mesh.axis_names for a in axes) \
                or n % mesh.size(axes):
            dims.append(None)
        else:
            dims.append(mesh.ordered(axes))
    return tuple(dims)


def shard_of(x: torch.Tensor, dims: tuple, coords: dict,
             mesh: Mesh) -> torch.Tensor:
    """The shard of the whole tensor ``x`` that the rank at ``coords``
    holds under ``dims``: a contiguous copy, also of a leaf that is not
    cut (the spawned ranks' arguments may share one storage)."""
    for i, axes in enumerate(dims):
        if axes is None:
            continue
        n = mesh.size(axes)
        idx = 0
        for a in axes:
            idx = idx * int(mesh.shape[a]) + coords[a]
        step = x.shape[i] // n
        x = x.narrow(i, idx * step, step)
    return x.clone(memory_format=torch.contiguous_format)


def owns(dims: tuple, coords: dict, mesh: Mesh) -> bool:
    """Whether the rank at ``coords`` is the one that counts its shard of
    a leaf under ``dims`` in a whole-tree sum: coordinate 0 on every axis
    the leaf is replicated over."""
    used = {a for axes in dims if axes for a in axes}
    return all(coords[a] == 0 for a in mesh.axis_names if a not in used)


def shard(x: torch.Tensor, *axes) -> torch.Tensor:
    """The reference's sharding constraint: the identity here."""
    del axes
    return x


def each_shard(fn, mesh: Mesh, *args):
    """``fn(coords, *args)`` as every rank runs it: on a process group
    once, with this rank's coordinates; on a single-process mesh once a
    shard in rank order, on each shard's slice of ``args`` (tensors, or
    tuples of them, with the mesh's leading dims), the results stacked
    back on the leading mesh dims (a result that is not a tensor, the
    same on every shard, is kept once). The per-rank body between two
    collectives runs through it, so one body serves both kinds of mesh."""
    if not mesh.local:
        return fn(mesh.coords(), *args)
    names = mesh.axis_names
    sizes = [int(mesh.shape[a]) for a in names]
    outs = [fn(dict(zip(names, c)), *_at(args, c))
            for c in itertools.product(*map(range, sizes))]
    return _stacked(outs, sizes)


def _at(tree, c: tuple):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_at(v, c) for v in tree)
    if not torch.is_tensor(tree):
        return tree
    return tree[tuple(i if n > 1 else 0
                      for i, n in zip(c, tree.shape[:len(c)]))]


def _stacked(outs: list, sizes: list):
    first = outs[0]
    if isinstance(first, (tuple, list)):
        return type(first)(_stacked([o[i] for o in outs], sizes)
                           for i in range(len(first)))
    if not torch.is_tensor(first):
        if any(o != first for o in outs):
            raise ValueError(f"shards returned {outs}")
        return first
    return torch.stack(outs).reshape(*sizes, *first.shape)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _abstract(x: torch.Tensor, mesh: Mesh, axes, kind: str, shape):
    """A collective of an abstract mesh: a meta tensor of ``shape`` (x's
    dtype), its bytes recorded as ``kind`` in the active trace; ``x``
    itself where the axes' size is 1."""
    if x.device.type != "meta":
        raise ValueError(f"an abstract mesh takes meta tensors only, got "
                         f"{x.device}")
    if mesh.size(axes) == 1:
        return x.contiguous()
    from repro_torch.analysis import op_trace
    tr = op_trace.current()
    out = torch.empty(tuple(shape), dtype=x.dtype, device="meta")
    if tr is not None:
        tr.collective(kind, out.numel() * out.element_size())
    return out


def _mesh_dims(mesh: Mesh, axes) -> list:
    return [mesh.axis_names.index(a) for a in mesh.ordered(axes)]


def _host(x: torch.Tensor, op: str) -> torch.Tensor:
    """``x`` where gloo takes it for ``op``: a host copy of a CUDA tensor
    when gloo's ``op`` runs on CPU tensors only."""
    if x.is_cuda and op not in GLOO_CUDA_OPS:
        return x.cpu()
    return x.contiguous()


def _reduce(x: torch.Tensor, axes, mesh: Mesh | None, op: str):
    mesh = mesh or current_mesh()
    if mesh is None:
        raise ValueError(f"p{op} needs an active mesh")
    if mesh.abstract:
        return _abstract(x, mesh, axes, "all-reduce", x.shape)
    if mesh.local:
        # shards stacked on the leading mesh dims; summed in shard order
        dims = _mesh_dims(mesh, axes)
        return x.amax(dims, keepdim=True) if op == "max" else x.sum(
            dims, keepdim=True)
    group = mesh.group_of(axes)
    if group is None:
        return x
    import torch.distributed as dist
    y = x.contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=group)
    return y


def pmax(x: torch.Tensor, axes, mesh: Mesh | None = None) -> torch.Tensor:
    """Elementwise max over the shards along ``axes``."""
    return _reduce(x, axes, mesh, "max")


def psum(x: torch.Tensor, axes, mesh: Mesh | None = None) -> torch.Tensor:
    """Elementwise sum over the shards along ``axes``."""
    return _reduce(x, axes, mesh, "sum")


def psum_scatter(x: torch.Tensor, axes, dim: int,
                 mesh: Mesh | None = None) -> torch.Tensor:
    """The sum over the shards along ``axes``, of which each rank keeps
    its block of ``dim`` (of a rank's tensor; block i at row-major index
    i over ``axes`` in mesh order): ``jax.lax.psum_scatter(tiled=True)``,
    half an all-reduce's traffic."""
    mesh = mesh or current_mesh()
    n = mesh.size(axes)
    if mesh.abstract:
        shape = list(x.shape)
        shape[dim] //= n
        return _abstract(x, mesh, axes, "reduce-scatter", shape)
    if mesh.local:
        nd = len(mesh.axis_names)
        dims = _mesh_dims(mesh, axes)
        y = x.sum(dims, keepdim=True).unflatten(nd + dim, (n, -1))
        idx = torch.arange(n, device=x.device).reshape(
            [int(mesh.shape[a]) if i in dims else 1
             for i, a in enumerate(mesh.axis_names)]
            + [1] * (y.dim() - nd))
        shape = list(y.shape)
        shape[nd + dim] = 1
        for i in dims:
            shape[i] = int(mesh.shape[mesh.axis_names[i]])
        return torch.take_along_dim(y.expand(*shape[:nd], *y.shape[nd:]),
                                    idx.expand(shape),
                                    dim=nd + dim).squeeze(nd + dim)
    group = mesh.group_of(axes)
    if group is None:
        return x.contiguous()
    import torch.distributed as dist
    src = _host(torch.movedim(x, dim, 0).contiguous(), "reduce_scatter_tensor")
    out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=group)
    return torch.movedim(out.to(x.device), 0, dim).contiguous()


def all_gather(x: torch.Tensor, axes, dim: int = 0,
               mesh: Mesh | None = None) -> torch.Tensor:
    """The shards along ``axes`` concatenated on ``dim`` (of a rank's
    tensor), row-major over ``axes`` in mesh order. On a single-process
    mesh the gathered mesh dims come out at size 1."""
    mesh = mesh or current_mesh()
    if mesh.abstract:
        shape = list(x.shape)
        shape[dim] *= mesh.size(axes)
        return _abstract(x, mesh, axes, "all-gather", shape)
    if mesh.local:
        nd = len(mesh.axis_names)
        pos = _mesh_dims(mesh, axes)
        full = [int(mesh.shape[a]) if i in pos else x.shape[i]
                for i, a in enumerate(mesh.axis_names)]
        y = x.expand(*full, *x.shape[nd:])
        rest = [i for i in range(nd) if i not in pos]
        y = y.permute(rest + pos + list(range(nd, x.dim())))
        k = len(rest)
        # the gathered mesh dims just ahead of the data dim, then merged
        y = torch.movedim(y, list(range(k, nd)),
                          list(range(k + dim, k + dim + len(pos))))
        y = y.flatten(k + dim, k + dim + len(pos))
        for p in pos:
            y = y.unsqueeze(p)
        return y.contiguous()
    group = mesh.group_of(axes)
    if group is None:
        return x.contiguous()
    import torch.distributed as dist
    src = _host(x, "all_gather")
    parts = [torch.empty_like(src) for _ in range(mesh.size(axes))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim).to(x.device)


def all_to_all(x: torch.Tensor, axis: str, split_axis: int,
               concat_axis: int, mesh: Mesh | None = None) -> torch.Tensor:
    """``jax.lax.all_to_all(..., tiled=False)`` over one mesh axis: a
    rank's dim ``split_axis`` (of size n, the axis's size) is sent out,
    block j to rank j, and the n blocks received are stacked as a new dim
    at ``concat_axis`` of the result, block j from rank j."""
    mesh = mesh or current_mesh()
    n = mesh.size(axis)
    if mesh.abstract:
        if x.shape[split_axis] != n:
            raise ValueError(f"all_to_all over {axis!r} of size {n}: dim "
                             f"{split_axis} has size {x.shape[split_axis]}")
        shape = list(x.shape)
        shape.insert(concat_axis, shape.pop(split_axis))
        return _abstract(x, mesh, axis, "all-to-all", shape)
    if mesh.local:
        nd = len(mesh.axis_names)
        p = mesh.axis_names.index(axis)
        full = list(x.shape)
        full[p] = n
        y = x.expand(*full).transpose(p, nd + split_axis)
        return torch.movedim(y, nd + split_axis,
                             nd + concat_axis).contiguous()
    if x.shape[split_axis] != n:
        raise ValueError(f"all_to_all over {axis!r} of size {n}: dim "
                         f"{split_axis} has size {x.shape[split_axis]}")
    group = mesh.group_of(axis)
    if group is None:
        return torch.movedim(x, split_axis, concat_axis).contiguous()
    import torch.distributed as dist
    # block j of dim 0 goes to rank j; block j of the result came from it
    src = _host(torch.movedim(x, split_axis, 0).contiguous(),
                "all_to_all_single")
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return torch.movedim(out.to(x.device), 0, concat_axis).contiguous()


def ppermute(x: torch.Tensor, axis: str,
             mesh: Mesh | None = None) -> torch.Tensor:
    """The ring hop: rank i's ``x`` goes to rank (i + 1) mod n along
    ``axis``; → what rank i − 1 sent."""
    mesh = mesh or current_mesh()
    n = mesh.size(axis)
    if mesh.abstract:
        return _abstract(x, mesh, axis, "collective-permute", x.shape)
    if mesh.local:
        p = mesh.axis_names.index(axis)
        full = list(x.shape)
        full[p] = n
        return torch.roll(x.expand(*full), shifts=1, dims=p).contiguous()
    group = mesh.group_of(axis)
    if group is None:
        return x.contiguous()
    import torch.distributed as dist
    src = _host(x, "send")
    me = mesh.rank(axis)
    peers = dist.get_process_group_ranks(group)
    out = torch.empty_like(src)
    sent = dist.isend(src, peers[(me + 1) % n], group=group)
    got = dist.irecv(out, peers[(me - 1) % n], group=group)
    sent.wait()
    got.wait()
    return out.to(x.device)
