"""Ring collective matmuls — the counterpart of the reference's
``distributed/collective_matmul.py``.

Instead of one blocking all-reduce after a row-parallel matmul, partial
products circulate a ring in chunks: the hop of chunk ``c`` can overlap
the product of chunk ``c + 1``. The reference leaves that overlap to
XLA's scheduler; here each hop is a :func:`~repro_torch.distributed.
partitioning.ppermute` (an ``isend``/``irecv`` pair) issued after its
chunk's product, in the reference's order, and the products stay
``torch.matmul``.

``ring_reduce_matmul(x, w)`` computes ``Y = Σᵢ Xᵢ @ Wᵢ`` (X, W cut on
the contraction dim over ``axis``), equal to ``psum(x_loc @ w_loc)`` up
to the order of the sum. ``allgather_matmul`` computes ``AllGather(X) @ W_loc``
without gathering X first.

On a single-process mesh a rank's operand is stacked on the leading mesh
dims, as the collectives take it (``partitioning``), and so is the result.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.partitioning import (Mesh, current_mesh,
                                                  each_shard, ppermute)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b, one 2-D product of contiguous operands a shard (a stacked
    single-process mesh loops over its shards): a batched or strided
    operand may take another GEMM algorithm than a rank's own product."""
    if a.dim() == 2 and b.dim() == 2:
        return torch.matmul(a.contiguous(), b.contiguous())
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a = a.expand(*batch, *a.shape[-2:]).reshape(-1, *a.shape[-2:])
    b = b.expand(*batch, *b.shape[-2:]).reshape(-1, *b.shape[-2:])
    return torch.stack([torch.matmul(x.contiguous(), y.contiguous())
                        for x, y in zip(a, b)]).reshape(
        *batch, a.shape[-2], b.shape[-1])


def ring_reduce_matmul(x_loc: torch.Tensor, w_loc: torch.Tensor, axis: str,
                       *, chunks: int = 4, mesh: Mesh | None = None):
    """x_loc [B, k_loc] @ w_loc [k_loc, n], summed over the ranks of
    ``axis``: the output's ``chunks`` column chunks, each circulated
    around the ring and added to at every hop (``acc = ppermute(acc) +
    partial``). → [B, n] on every rank."""
    mesh = mesh or current_mesh()
    n_ranks = mesh.size(axis)
    n = w_loc.shape[-1]
    chunks = min(chunks, n)
    if n % chunks:
        raise ValueError(f"{n} columns do not cut into {chunks} chunks")
    cw = n // chunks
    outs = []
    for c in range(chunks):
        partial = _mm(x_loc, w_loc[..., c * cw:(c + 1) * cw])
        acc = partial
        for _ in range(n_ranks - 1):
            acc = ppermute(acc, axis, mesh) + partial
        outs.append(acc)
    return torch.cat(outs, dim=-1)


def allgather_matmul(x_loc: torch.Tensor, w_loc: torch.Tensor, axis: str,
                     *, mesh: Mesh | None = None) -> torch.Tensor:
    """x_loc [b_loc, k] (rows cut over ``axis``) @ w_loc [k, n_loc]: the
    activation blocks stream around the ring and each is multiplied as it
    arrives. → [b_loc · n, n_loc], block t of rank ``me`` (from rank
    ``(me − t) mod n``) at rows ``((me − t) mod n) · b_loc``."""
    mesh = mesh or current_mesh()
    n_ranks = mesh.size(axis)
    cur, ys = x_loc, []
    for t in range(n_ranks):
        ys.append(_mm(cur, w_loc))
        if t < n_ranks - 1:
            cur = ppermute(cur, axis, mesh)
    # row block q holds the product of rank q's rows: hop t = (me − q) mod n
    return each_shard(lambda c, *y: torch.cat(
        [y[(c[axis] - q) % n_ranks] for q in range(n_ranks)], dim=-2),
        mesh, *ys)
