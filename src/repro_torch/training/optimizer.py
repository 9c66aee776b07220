"""AdamW on a tree of tensors, the reference's arithmetic, in place.

Moments are f32 whatever the parameter's dtype (QAT trains f32 masters;
the STE forward quantizes and the optimizer never sees it). The update
runs in place, leaf by leaf and, in a leaf, in blocks of rows along its
first axis (a layer at a time on a stacked leaf), so its temporaries are
a block's: at bitnet-3b's full width one out-of-place temporary of the
stacked FFN leaf [26, 3200, 8640] would be 2.9 GB. Each element goes
through the reference's operations in its order, so a block's values do
not depend on the blocking.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.tree_util import leaves, tree_map

# elements in one block of an in-place pass (128 MiB of f32)
BLOCK = 1 << 25


class AdamWState(NamedTuple):
    step: torch.Tensor       # int32, 0-d
    m: dict                  # first moment (f32, parameter-shaped)
    v: dict                  # second moment (f32, parameter-shaped)


def adamw_init(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def _blocks(x: torch.Tensor):
    """Slices of ``x`` along its first axis of at most ``BLOCK`` elements
    each (one row at least)."""
    if x.dim() == 0:
        yield ()
        return
    rows = max(1, BLOCK // max(1, x[0].numel()))
    for i in range(0, x.shape[0], rows):
        yield slice(i, i + rows)


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b, dividing by a tensor: on CUDA, ``t / python_scalar``
    multiplies by the reciprocal, which is not the IEEE quotient."""
    return a / torch.full_like(a, b)


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1):
    """One AdamW step, in place on ``params`` and the moments. → (params,
    the new state). ``lr`` is a float or an f32 0-d tensor."""
    step = state.step + 1
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, stepf)
    bc2 = 1.0 - torch.pow(b2, stepf)
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.m),
                          leaves(state.v)):
        for sl in _blocks(p):
            gb = g[sl].to(torch.float32)
            mb, vb = m[sl], v[sl]
            mb.mul_(b1).add_((1 - b1) * gb)
            vb.mul_(b2).add_((1 - b2) * torch.square(gb))
            delta = (mb / bc1) / (torch.sqrt(vb / bc2) + eps) \
                + weight_decay * p[sl].to(torch.float32)
            p[sl] -= (lr * delta).to(p.dtype)
    return params, AdamWState(step=step, m=state.m, v=state.v)


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    """sqrt of the f32 sum of squares of every leaf (leaf sums in the
    reference's leaf order)."""
    total = None
    for x in leaves(tree):
        s = sum(torch.sum(torch.square(x[sl].to(torch.float32)))
                for sl in _blocks(x))
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, norm=None):
    """Scale ``grads`` in place by min(1, max_norm / (norm + 1e-9)). →
    (grads, norm). ``norm``: the whole tree's, where the caller has it (a
    sharded tree's, from every rank's shards); else ``global_norm``."""
    if norm is None:
        norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    for g in leaves(grads):
        for sl in _blocks(g):
            g[sl] *= scale
    return grads, norm


def warmup_cosine(step, *, peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> torch.Tensor:
    """Linear warmup → cosine decay to ``floor``·peak, in f32 (``step`` an
    integer tensor or int)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = _div(peak_lr * step, float(max(warmup, 1)))
    frac = torch.clamp(_div(step - warmup, float(max(total - warmup, 1))),
                       0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5
                     * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup, warm, cos)
