"""Chunked sequential scan with per-chunk rematerialization, the
reference's ``models/scan_utils.py:chunked_scan``.

The scan runs in chunks of ``chunk`` steps: the clean prefix chunk by
chunk, each chunk under a non-reentrant ``torch.utils.checkpoint`` when
``remat`` is set and autograd records (so training keeps one carry a
chunk and the backward recomputes each chunk's steps transiently), the
ragged tail in one piece without remat, as the reference runs it. The
forward value is the plain loop's: the same chunk function on the same
carry in the same order, so serving (``remat=False``, no autograd)
gets the values of one plain loop. Inside ``forward_train`` the chunks'
checkpoints nest within the layer stack's own
(:func:`repro_torch.models.transformer._scan_stack`).

The reference's ``accounting_unroll`` is a dry-run costing knob and is
not copied; its ``stacked_init`` is the port's
:func:`repro_torch.models.transformer.stack_trees`.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def stepwise(body):
    """The chunk function of a step function: ``body(carry, x_t) →
    (carry, y_t)``, with ``x_t`` the tuple of the chunk's rows at t, run
    over every step of the chunk. → ``run(carry, xs_c) → (carry, the y_t
    stacked)``."""
    def run(carry, xs):
        ys = []
        for t in range(xs[0].shape[0]):
            carry, y = body(carry, tuple(a[t] for a in xs))
            ys.append(y)
        return carry, torch.stack(ys)
    return run


def chunked_scan(run, carry, xs, *, chunk: int = 64, remat: bool = True):
    """``lax.scan`` over ``xs`` (a tuple of tensors sharing a leading time
    axis T) in remat'd chunks: ``run(carry, xs_c) → (carry, ys_c)`` takes
    one chunk's rows at once (:func:`stepwise` makes it of a step
    function; rwkv6's wkv forms a chunk's products together). → (the
    carry after step T, the ys on the leading axis)."""
    t = xs[0].shape[0]
    chunk = min(chunk, t)
    head = t - t % chunk
    remat = remat and torch.is_grad_enabled()
    ys = []
    for c0 in range(0, head, chunk):
        seg = tuple(a[c0:c0 + chunk] for a in xs)
        if remat:
            carry, y = checkpoint(run, carry, seg, use_reentrant=False)
        else:
            carry, y = run(carry, seg)
        ys.append(y)
    if head < t:
        carry, y = run(carry, tuple(a[head:] for a in xs))
        ys.append(y)
    return carry, ys[0] if len(ys) == 1 else torch.cat(ys)
