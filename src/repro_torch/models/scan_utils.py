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
:func:`repro_torch.models.transformer.stack_trees`. The port's dry-run
counterpart is the traced replay: on meta tensors under an active
:class:`repro_torch.analysis.op_trace.OpTrace` (the dry-run), a scan of
three or more full chunks runs its first chunk, measures one chunk's
forward (and, under autograd, its recompute and backward) on fresh
inputs of the same shapes in a trace of its own, and replays every
later full chunk as one autograd node that records that measured cost
and makes outputs (and, in the backward, gradients) of the same shapes
— every chunk of a scan runs the same ops on the same shapes, so the
costs are every chunk's, while a full-length time loop of meta ops
(~0.2 ms each) would take hours at the dry-run's 32k tokens. A
:func:`stepwise` chunk replays its steps past the first the same way.
The ragged tail runs as it is.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def stepwise(body):
    """The chunk function of a step function: ``body(carry, x_t) →
    (carry, y_t)``, with ``x_t`` the tuple of the chunk's rows at t, run
    over every step of the chunk. → ``run(carry, xs_c) → (carry, the y_t
    stacked)``. ``body.params`` (if set): the tensors the body reads
    besides its arguments, for the traced replay of its steps (module
    docstring; without them a traced chunk under autograd runs every
    step)."""
    params = getattr(body, "params", None)

    def run(carry, xs):
        n = xs[0].shape[0]
        grad = _grad(carry, *xs, *(params or ()))
        tr = _tracing(carry, n) if params is not None or not grad else None
        replay = None
        ys = []
        for t in range(n):
            x_t = tuple(a[t] for a in xs)
            if replay is not None:
                carry, y = _Replay.apply(replay, carry, *x_t, *(params or ()))
            else:
                carry, y = body(carry, x_t)
                if tr is not None:
                    replay = _measure(tr, body, carry, y, x_t, params or (),
                                      grad, remat=False)
            ys.append(y)
        return carry, torch.stack(ys)
    return run


def chunked_scan(run, carry, xs, *, chunk: int = 64, remat: bool = True,
                 params: tuple = ()):
    """``lax.scan`` over ``xs`` (a tuple of tensors sharing a leading time
    axis T) in remat'd chunks: ``run(carry, xs_c) → (carry, ys_c)`` takes
    one chunk's rows at once (:func:`stepwise` makes it of a step
    function; rwkv6's wkv forms a chunk's products together). → (the
    carry after step T, the ys on the leading axis). ``params``: the
    tensors ``run`` reads besides ``carry`` and ``xs`` (its closure, those
    very tensors), which a traced replay (module docstring) passes
    gradients to."""
    t = xs[0].shape[0]
    chunk = min(chunk, t)
    head = t - t % chunk
    remat = remat and torch.is_grad_enabled()
    grad = _grad(carry, *xs, *params)
    tr = _tracing(carry, head // chunk) if remat or not grad else None
    replay = None
    ys = []
    for c0 in range(0, head, chunk):
        seg = tuple(a[c0:c0 + chunk] for a in xs)
        if replay is not None:
            carry, y = _Replay.apply(replay, carry, *seg, *params)
        elif remat:
            carry, y = checkpoint(run, carry, seg, use_reentrant=False)
        else:
            carry, y = run(carry, seg)
        if tr is not None and replay is None:
            replay = _measure(tr, run, carry, y, seg, params, grad,
                              remat=remat)
        ys.append(y)
    if head < t:
        carry, y = run(carry, tuple(a[head:] for a in xs))
        ys.append(y)
    return carry, ys[0] if len(ys) == 1 else torch.cat(ys)


# ---------------------------------------------------------------------------
# the dry-run's replay of identical chunks
# ---------------------------------------------------------------------------

def _grad(*tensors) -> bool:
    """Whether autograd records a loop over ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _tracing(carry, n: int):
    """The active trace when a loop of ``n`` iterations replays (module
    docstring): a meta carry and three or more iterations (chunks, or
    steps of a chunk); under autograd the callers replay only a remat'd
    chunk or a step whose body names its closure tensors."""
    if n < 3 or not isinstance(carry, torch.Tensor) \
            or carry.device.type != "meta":
        return None
    return _current()


def _current():
    from repro_torch.analysis import op_trace
    return op_trace.current()


class _Plan:
    """One iteration's measured costs and its outputs' shapes; ``saves``:
    whether its replay saves tensors for the backward — a step's does, as
    the step it stands for does, so a remat'd chunk's recompute runs
    through it; a chunk's saves none (its measured backward holds its
    recompute)."""

    def __init__(self, fwd, bwd, carry, y, saves: bool):
        self.fwd, self.bwd = fwd, bwd
        self.carry = (carry.shape, carry.dtype)
        self.y = (y.shape, y.dtype)
        self.saves = saves


def _measure(tr, run, carry, y, seg, params, grad: bool, *,
             remat: bool) -> _Plan:
    """One iteration's forward and (with ``grad``) its backward — a
    remat'd chunk's under its checkpoint, so with its recompute — run on
    fresh meta inputs of the first iteration's shapes in a trace of their
    own (the outer trace paused: it sees their allocations, not their
    costs)."""
    from repro_torch.analysis.op_trace import OpTrace

    def fresh(x):
        # without autograd the iteration's own inputs do (no copies made)
        if not grad:
            return x
        return torch.empty(x.shape, dtype=x.dtype, device=x.device
                           ).requires_grad_(x.is_floating_point())
    # apart from any checkpoint around the scan (identity hooks over its
    # saved-tensor hooks, which would make this backward recompute the
    # enclosing layer)
    with tr.paused(), torch.autograd.graph.saved_tensors_hooks(
            lambda x: x, lambda x: x):
        c_in = fresh(carry)
        s_in = tuple(fresh(a) for a in seg)
        with torch.enable_grad() if grad else torch.no_grad():
            with OpTrace() as sub:
                if grad and remat:
                    c_out, y_out = checkpoint(run, c_in, s_in,
                                              use_reentrant=False)
                else:
                    c_out, y_out = run(c_in, s_in)
            fwd = sub.total()
            bwd = None
            if grad:
                wrt = [x for x in (c_in, *s_in, *params) if x.requires_grad]
                outs = [o for o in (c_out, y_out) if o.requires_grad]
                seeds = [torch.empty_like(o) for o in outs]
                # the checkpoint's recompute (up to the last saved tensor
                # the backward needs) and the backward itself
                # (retain_graph: a closure tensor's own graph is the
                # program's, whose buffers its backward still needs)
                with OpTrace() as sub_b:
                    torch.autograd.grad(outs, wrt, seeds, retain_graph=True,
                                        allow_unused=True)
                bwd = sub_b.total()
    return _Plan(fwd, bwd, carry, y, saves=not remat)


class _Replay(torch.autograd.Function):
    """An iteration after the first, under the dry-run's trace: its
    measured forward cost recorded and outputs of the first iteration's
    shapes made; its backward records the measured backward and makes a
    gradient for each input that needs one (a step's saves its inputs
    and carry out: :class:`_Plan`)."""

    @staticmethod
    def forward(ctx, plan, carry, *rest):
        ctx.plan = plan
        ctx.shapes = [(x.shape, x.dtype) for x in (carry, *rest)]
        # the trace active now (a measurement's own, when one replays)
        tr = _current()
        tr.absorb(plan.fwd)
        with tr.paused():
            outs = (torch.empty(plan.carry[0], dtype=plan.carry[1],
                                device="meta"),
                    torch.empty(plan.y[0], dtype=plan.y[1], device="meta"))
        if plan.saves:
            ctx.save_for_backward(carry, *rest, outs[0])
        return outs

    @staticmethod
    def backward(ctx, *grads):
        tr = _current()
        tr.absorb(ctx.plan.bwd)
        with tr.paused():
            return (None, *(torch.empty(shape, dtype=dtype, device="meta")
                            if need else None for (shape, dtype), need in
                            zip(ctx.shapes, ctx.needs_input_grad[1:])))
