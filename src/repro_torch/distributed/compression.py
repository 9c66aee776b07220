"""Gradient compression: an int8 all-reduce with error feedback — the
reference's ``distributed/compression.py``.

The ranks agree on one scale per tensor (``pmax`` of the local absmax,
``max(amax, 1e-12) / 127``), quantize to int8 (round half to even, clip
to ±127), sum the codes as int32 (``psum``) and dequantize once. The
local quantization residual is returned as the new error state, which
the caller adds into the next round's tensor, so the compression's bias
vanishes over rounds.

It runs over a :class:`~repro_torch.distributed.partitioning.Mesh` of
either kind: over a ``torch.distributed`` group each rank passes its own
tensor and the collectives are ``all_reduce`` MAX and SUM (the int32
codes go through gloo as int32, on CPU and CUDA tensors alike); on a
single-process mesh the shards' tensors are stacked on axis 0, each
shard's absmax is its own slice's, and the sum keeps the axis at size 1,
as :func:`~repro_torch.distributed.partitioning.psum` does. Both give the
same values: the max and the integer sum are exact in any order.

Every division is by a tensor (on CUDA, ``t / python_scalar`` multiplies
by the reciprocal, which is not the IEEE quotient XLA computes), and the
residual is formed exactly and rounded once, as XLA's fused multiply-add
forms it, so the values are the reference's bit for bit on either
device.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.partitioning import current_mesh, pmax, psum
from repro_torch.tree_util import leaves, tree_map, unflatten

INT8_MAX = 127.0


def _local_absmax(xf: torch.Tensor, local: bool) -> torch.Tensor:
    """Each shard's max |x|: 0-d on a rank, [n, 1, …] for n stacked
    shards."""
    if not local:
        return xf.abs().amax()
    n = xf.shape[0]
    return xf.abs().reshape(n, -1).amax(1).reshape(n, *[1] * (xf.dim() - 1))


def compressed_psum(x: torch.Tensor, axes, err: torch.Tensor,
                    mesh=None):
    """The int8-compressed ``psum`` of ``x`` over ``axes`` with error
    feedback. → (≈ the sum of the shards' x, f32; the new local error
    state, f32, x's shape)."""
    mesh = mesh or current_mesh()
    if mesh is None:
        raise ValueError("compressed_psum needs a mesh")
    xf = x.to(torch.float32) + err
    amax = pmax(_local_absmax(xf, mesh.local), axes, mesh)
    scale = torch.clamp_min(amax, 1e-12) / torch.full_like(amax, INT8_MAX)
    q = torch.clamp(torch.round(xf / scale), -INT8_MAX, INT8_MAX)
    # the residual exactly, rounded once: XLA fuses xf − q·scale into one
    # multiply-add, and in float64 both the product (a 7-bit integer times
    # a 24-bit scale) and the difference (within scale/2 of xf) are exact
    new_err = (xf.to(torch.float64) - q.to(torch.float64)
               * scale.to(torch.float64)).to(torch.float32)
    total = psum(q.to(torch.int32), axes, mesh)
    return total.to(torch.float32) * scale, new_err


def compressed_psum_tree(grads, axes, err_tree, mesh=None):
    """:func:`compressed_psum` over every leaf of ``grads`` (a tensor
    tree; ``err_tree`` of the same structure). → (the summed tree, the new
    error tree)."""
    outs = [compressed_psum(g, axes, e, mesh)
            for g, e in zip(leaves(grads), leaves(err_tree))]
    return (unflatten(grads, [o[0] for o in outs]),
            unflatten(grads, [o[1] for o in outs]))


def init_error_state(grads_like):
    """Zero f32 error state shaped as ``grads_like``."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)


class CompressedMean:
    """A ``compress_grads`` hook of :func:`repro_torch.training.train.
    make_train_step` for data parallelism: the gradient tree's
    :func:`compressed_psum_tree` over ``axes`` divided by the number of
    shards, the error state kept from call to call (zero at the first).
    On a single-process mesh it takes the shards' gradients stacked on
    axis 0 and returns one tree."""

    def __init__(self, axes, mesh=None):
        self.axes, self.mesh, self.err = axes, mesh, None

    def __call__(self, grads):
        mesh = self.mesh or current_mesh()
        if self.err is None:
            self.err = init_error_state(grads)
        total, self.err = compressed_psum_tree(grads, self.axes, self.err,
                                               mesh)

        def mean(t):
            t = t / torch.full_like(t, float(mesh.size(self.axes)))
            return t[0] if mesh.local else t
        return tree_map(mean, total)
