"""Sequential scan over time, the forward of the reference's
``chunked_scan``.

The reference cuts the scan into chunks of ``chunk`` steps and
rematerializes each chunk's body so that training keeps O(T / chunk)
residuals; the forward value is ``lax.scan``'s, step for step, ragged tail
included. Serving keeps no residuals, so the port runs the steps in one
loop: the same body on the same carry in the same order gives the same
values. The remat (the reference checkpoints each chunk's body) comes
with the recurrent families' training, which is not ported yet; the
reference's ``accounting_unroll`` is a dry-run costing knob and is not
copied (the layer stack's remat is
:func:`repro_torch.models.transformer._scan_stack`'s); its
``stacked_init`` is the port's
:func:`repro_torch.models.transformer.stack_trees`.
"""

from __future__ import annotations

import torch


def chunked_scan(body, carry, xs):
    """``lax.scan(body, carry, xs)``: ``xs`` a tuple of tensors sharing a
    leading time axis T, ``body(carry, x_t) → (carry, y_t)`` with ``x_t``
    the tuple of their rows at t. → (the carry after step T, the y_t
    stacked on a new leading axis). The reference's ``chunk`` does not
    change the forward, so the port takes none."""
    ys = []
    for t in range(xs[0].shape[0]):
        carry, y = body(carry, tuple(a[t] for a in xs))
        ys.append(y)
    return carry, torch.stack(ys)
