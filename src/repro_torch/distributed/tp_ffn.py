"""Tensor parallelism for the whole FFN: shard the hidden f axis — the
counterpart of the reference's ``distributed/tp_ffn.py``.

Each rank runs the same whole-FFN kernel (#2,
:func:`repro_torch.kernels.ops.ffn_fused`) over its contiguous block of
f/n hidden features: its columns of **both** the gate and the up stream
(``gu_packed [..., d/4, 2f]`` is gate ‖ up, viewed as ``[..., d/4, segs,
f]`` and cut on the last axis) and the matching rows of ``down_packed``
(packed row r covers features 4r..4r+3, so equal contiguous blocks line
up). The partial down outputs are summed over the axis: dequantization is
linear in the integer accumulator, so the sum of the shards' partials is
the full projection — except that the kernel's hidden re-barrier runs per
rank, over its f/n features instead of all f. The result is therefore
bitwise the unsharded kernel only at n = 1, and within int8 quantization
noise of it at n > 1, as in the reference.

The opt-in is explicit, as in the reference: :func:`use_ffn_tp` around
the serving call, under an active mesh. Without it, without a mesh
holding the axis, or where the down rows do not divide, every consumer
runs the single-launch path unchanged.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

from repro_torch.distributed.partitioning import current_mesh, psum
from repro_torch.kernels import ops

_state = threading.local()


@contextmanager
def use_ffn_tp(axis: str = "model"):
    """Shard the f axis of every whole FFN over mesh axis ``axis`` for the
    scope (``core/qlinear.ffn_node_apply`` reads it)."""
    prev = getattr(_state, "axis", None)
    _state.axis = axis
    try:
        yield
    finally:
        _state.axis = prev


def ffn_tp_axis() -> str | None:
    return getattr(_state, "axis", None)


def _shard_operands(gu_packed, gu_scale, down_packed, segs: int, f: int,
                    r: int, n: int):
    """Rank r's f block of the gate‖up stream (both segments), its γ and
    its down rows."""
    f_l = f // n
    lo, hi = r * f_l, (r + 1) * f_l
    gu = gu_packed.reshape(*gu_packed.shape[:-1], segs, f)[..., lo:hi]
    gs = gu_scale.to(torch.float32).expand(
        *gu_scale.shape[:-1], segs * f).reshape(
        *gu_scale.shape[:-1], segs, f)[..., lo:hi]
    return (gu.reshape(*gu.shape[:-2], segs * f_l),
            gs.reshape(*gs.shape[:-2], segs * f_l),
            down_packed[..., lo // 4:hi // 4, :])


def ffn_fused_tp(x, gu_packed, gu_scale, down_packed, down_scale, *,
                 gated: bool, act: str, mesh=None, axis: str = "model"):
    """The whole FFN, f-sharded over ``mesh[axis]``: the operands and the
    result of :func:`repro_torch.kernels.ops.ffn_fused` (leading expert
    dims ride along); each rank (each shard, on a single-process mesh)
    launches #2 on its f block and the partials are summed."""
    mesh = mesh or current_mesh()
    if mesh is None or axis not in mesh.axis_names:
        raise ValueError(f"no mesh with axis {axis!r}")
    segs = 2 if gated else 1
    f = down_packed.shape[-2] * 4
    if gu_packed.shape[-1] != segs * f:
        raise ValueError(f"gate‖up {tuple(gu_packed.shape)} is not {segs} "
                         f"segments of f={f}")
    n = mesh.size(axis)
    if (f // 4) % n:
        raise ValueError(f"f={f} does not cut into {n} blocks of whole "
                         f"packed rows")
    ranks = range(n) if mesh.local else (mesh.rank(axis),)
    parts = []
    for r in ranks:
        gu, gs, dn = _shard_operands(gu_packed, gu_scale, down_packed, segs,
                                     f, r, n)
        parts.append(ops.ffn_fused(x, gu, gs, dn, down_scale, gated=gated,
                                   act=act))
    part = torch.stack(parts) if mesh.local else parts[0]
    out = psum(part, axis, mesh)
    return out[0] if mesh.local else out


def maybe_shard_f(node, x, *, gated: bool, act: str):
    """The f-sharded FFN where :func:`use_ffn_tp` is on, a mesh holds its
    axis and the down rows divide; else None (the caller runs the
    single-launch path)."""
    axis = ffn_tp_axis()
    if axis is None:
        return None
    mesh = current_mesh()
    if mesh is None or axis not in mesh.axis_names:
        return None
    n = mesh.size(axis)
    if n <= 0 or node["down_packed"].shape[-2] % n:
        return None
    return ffn_fused_tp(x, node["gu_packed"], node["gu_scale"],
                        node["down_packed"], node["down_scale"], gated=gated,
                        act=act, mesh=mesh, axis=axis)
