"""Knife-edges: where two runs of the QAT forward part only because f32
rounding resolves a near-tie apart. For ``chip_smoke.py`` (card against
CPU), ``tests/test_torch_gpu.py`` and ``tests/test_torch_recurrent_
training.py`` (port against the JAX reference); it imports no JAX.

A QAT BitLinear call quantizes its input x to int8 (x/scale rounded half
to even) and its master w to ternary codes (w/γ rounded, γ = mean |w|).
Two runs whose x or γ differ in the last bits part where x/scale sits on
a half-integer, or |w|/γ on ½: a knife-edge, not a fault, but one that
the layers after it carry. :func:`bitlinear_inputs` records every call's
operands and can hand a run another run's int8 activations and ternary
codes in value (its own gradient kept), so the rest of the computation
can be held tight; :func:`knife_edges` asserts that every parting of two
recordings is such a tie.
"""
import contextlib
import math

import torch

CODE_MARGIN = 1e-5          # |w|/γ from ½ where two runs' codes part


@contextlib.contextmanager
def bitlinear_inputs(replay=None):
    """Record every QAT BitLinear call's input x, master w and ternary
    weight (γ·t, ``ste_ternary``'s value) as CPU copies, in call order,
    into the list yielded. With ``replay`` (such a list from another run
    of the same code) x and the ternary weight are replaced in value by
    their twins, a + (twin − a).detach(): the twin's int8 activations and
    ternary codes, the gradients this run's own."""
    from repro_torch.core import ternary
    from repro_torch.models import layers

    real, real_tern, rec = layers.bitlinear_qat, ternary.ste_ternary, []

    def as_twin(a, twin):
        return a + (twin.to(a.device) - a).detach()

    def wrapped(x, w, *args, **kw):
        i = len(rec)
        rec.append([x.detach().to("cpu", copy=True),
                    w.detach().to("cpu", copy=True), None])
        if replay is not None:
            x = as_twin(x, replay[i][0])

        def tern(w_, *a, **k):
            wq = real_tern(w_, *a, **k)
            rec[i][2] = wq.detach().to("cpu", copy=True)
            return wq if replay is None else as_twin(wq, replay[i][2])
        ternary.ste_ternary = tern
        try:
            return real(x, w, *args, **kw)
        finally:
            ternary.ste_ternary = real_tern
    layers.bitlinear_qat = wrapped
    try:
        yield rec
    finally:
        layers.bitlinear_qat = real


def knife_edges(ours: list, theirs: list, margin: float,
                first_only: bool = False):
    """The partings of two runs' recorded BitLinear calls ([x, w, γ·t]
    each, as :func:`bitlinear_inputs` records them), call by call (with
    ``first_only``, up to the first call that parts: the calls after it
    carry its flip). Where the int8 values part, x/scale must lie within
    ``margin`` of one half-integer on both sides; where the ternary codes
    part, |w|/γ within ``CODE_MARGIN`` of ½ on both sides. Anything else
    raises. → (int8 partings, code partings, the first parting call's
    index or None, the widest distance from a half-integer)."""
    from repro_torch.core.quantization import quantize

    n, codes, first, widest = 0, 0, None, 0.0
    for i, ((a, w, wa), (b, _, wb)) in enumerate(zip(ours, theirs)):
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        qa, qb = quantize(a), quantize(b)
        apart = (qa.values != qb.values).nonzero().tolist()
        for j in apart:
            ra = float(a[tuple(j)] / qa.scale[tuple(j[:-1])])
            rb = float(b[tuple(j)] / qb.scale[tuple(j[:-1])])
            h = math.floor(ra) + 0.5
            far = max(abs(ra - h), abs(rb - h))
            if far > margin:
                raise AssertionError(f"call {i} element {j}: x/scale "
                                     f"{ra} / {rb}, not a knife-edge")
            widest = max(widest, far)
        w, wa, wb = (torch.as_tensor(t) for t in (w, wa, wb))
        flip = torch.sign(wa) != torch.sign(wb)
        if flip.any():
            for g in (wa.abs().amax(), wb.abs().amax()):
                r = float((w[flip].abs() / g).sub(0.5).abs().max())
                if r > CODE_MARGIN:
                    raise AssertionError(f"call {i}: {int(flip.sum())} "
                                         f"ternary codes part, |w|/γ "
                                         f"{r + 0.5} from ½")
        parted = bool(apart) or bool(flip.any())
        if parted and first is None:
            first = i
        n, codes = n + len(apart), codes + int(flip.sum())
        if first_only and parted:
            break
    return n, codes, first, widest


def step1_grads(cfg, masters, batch, dev: str, replay=None):
    """Step 1's loss and pre-clip gradient norm of ``masters`` (copied to
    ``dev``) on ``batch`` (numpy), no remat (one BitLinear call per site),
    every BitLinear call recorded (and, with ``replay``, given its twin's
    int8 activations and ternary codes). → (loss, grad norm, the
    recording)."""
    from repro_torch.training.optimizer import global_norm
    from repro_torch.training.train import loss_fn
    from repro_torch.tree_util import leaves, tree_map

    params = tree_map(lambda t: t.to(dev, copy=True), masters)
    for p in leaves(params):
        p.requires_grad_(True)
    with bitlinear_inputs(replay) as rec:
        loss, _ = loss_fn(cfg, params, {
            k: torch.from_numpy(v).to(dev) for k, v in batch.items()},
            remat=False)
        loss.backward()
    norm = global_norm(tree_map(lambda p: p.grad, params))
    return float(loss.detach()), float(norm), rec
