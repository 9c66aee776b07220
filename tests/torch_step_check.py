"""The check of one training step against another taken from the same
masters (a sharded step against one device's, the port's against the
reference's), shared by ``tests/test_torch_distributed.py`` and phase 4m
of ``chip_smoke.py``: a module of its own that imports torch alone.

A check on the parameters alone cannot see the update: at the first
step AdamW moves each element by about lr whatever its gradient, so an
absolute bound of a few lr passes a skipped or a flipped update. Here
each leaf's update p′ − p is held to the other step's relative to its
norm and element by element (in units of lr), and both moments relative
to their norms. AdamW's update of an element is ~lr·sign(g) unless its
gradient is within a few eps of zero or its sign parts between the two
steps: such an element (first moments of opposite signs, or one of them
at most ``M_FLOOR``) follows its gradient's rounding, so it is left out
of the update's two bounds; the moments' bounds cover every element.

The sums are kept per leaf and add over disjoint shards, so ranks that
each hold a shard can check their own part (:func:`leaf_sums`) and one
process can add them (:func:`step_faults`). :func:`planted` plants the
faults the check must catch.
"""
from contextlib import contextmanager

import torch

UPDATE_TOL = 1e-3       # per leaf ||Δp − Δp_want|| / ||Δp_want||
ELEM_TOL = 0.05         # per element |Δp − Δp_want| / lr
MOMENT_TOL = 1e-5       # per leaf relative gap of m and of v
ROWS = 1 << 22          # elements a block, to bound the temporaries
# a first moment this small is a gradient within 20·eps of zero (m = (1 −
# β1)·g at step 1; AdamW's eps 1e-8), where the update g / (|g| + eps)
# is no longer ~sign(g) and follows the gradient's rounding
M_FLOOR = 20 * 1e-8 * (1 - 0.9)
# the checked step's schedule: a real first update, lr 1e-4 at step 1
# (warmup 1), as against the reference check's 3e-6 (warmup 100 of 10
# steps), under which a skipped update parted by less than a sound one
STEP = dict(peak_lr=1e-4, warmup=1, total_steps=10, max_grad_norm=1.0)
FAULTS = ("zero", "sign", "swap")

# the fields of a leaf's sums
FIELDS = ("gap2", "upd2", "gap_max", "m_gap2", "m2", "v_gap2", "v2",
          "left_out", "n")


@torch.no_grad()
def leaf_sums(p0, got, want) -> torch.Tensor:
    """One leaf's (or one shard's) sums, float64 on the host, in the
    order of ``FIELDS``. ``got`` and ``want`` are (p′, m, v) after one
    step from ``p0``, tensors of p0's shape on any one device."""
    out = torch.zeros(len(FIELDS), dtype=torch.float64)
    flat = [t.reshape(-1) for t in (p0, *got, *want)]
    n = flat[0].numel()
    for i in range(0, n, ROWS):
        p, pg, mg, vg, pw, mw, vw = (t[i:i + ROWS].double() for t in flat)
        dm = mg - mw
        free = (dm == 0) | ((torch.sign(mg) == torch.sign(mw))
                            & (torch.minimum(mg.abs(), mw.abs()) > M_FLOOR))
        gap = ((pg - p) - (pw - p))[free]
        zero = torch.zeros((), dtype=torch.float64, device=p.device)
        out = add_sums(out, torch.stack([
            gap.square().sum(), (pw - p)[free].square().sum(),
            gap.abs().max() if gap.numel() else zero,
            dm.square().sum(), mw.square().sum(), (vg - vw).square().sum(),
            vw.square().sum(), (~free).sum().double(),
            zero + p.numel()]).cpu())
    return out


def add_sums(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two disjoint shards' sums as one."""
    out = a + b
    out[2] = max(a[2], b[2])
    return out


def step_faults(sums: dict, lr: float, moments: bool = True) -> list:
    """{path: sums} (each whole leaf's) → the leaves where the step parts
    from the wanted one: (path, what, value) for an update gap above
    UPDATE_TOL of its norm or ELEM_TOL·lr in an element, or (with
    ``moments``) a moment gap above MOMENT_TOL of its norm."""
    faults = []
    for path, s in sums.items():
        f = dict(zip(FIELDS, s.tolist()))
        rel = (f["gap2"] / max(f["upd2"], 1e-300)) ** 0.5
        if rel > UPDATE_TOL:
            faults.append((path, "update", rel))
        if f["gap_max"] > ELEM_TOL * lr:
            faults.append((path, "element", f["gap_max"] / lr))
        for mom in ("m", "v") if moments else ():
            rel = (f[f"{mom}_gap2"] / max(f[f"{mom}2"], 1e-300)) ** 0.5
            if rel > MOMENT_TOL:
                faults.append((path, mom, rel))
    return faults


def worst(sums: dict, lr: float) -> dict:
    """The largest of each measure over the leaves, for the record:
    update and moment gaps relative to their norms, the element gap in
    units of lr, and the elements left out of the update's bounds."""
    out = {"update": 0.0, "element": 0.0, "m": 0.0, "v": 0.0,
           "left_out": 0, "n": 0}
    for s in sums.values():
        f = dict(zip(FIELDS, s.tolist()))
        out["update"] = max(out["update"],
                            (f["gap2"] / max(f["upd2"], 1e-300)) ** 0.5)
        out["element"] = max(out["element"], f["gap_max"] / lr)
        for mom in ("m", "v"):
            out[mom] = max(out[mom], (f[f"{mom}_gap2"]
                                      / max(f[f"{mom}2"], 1e-300)) ** 0.5)
        out["left_out"] += int(f["left_out"])
        out["n"] += int(f["n"])
    return out


@contextmanager
def planted(fault=None):
    """A fault planted in the sharded step while the scope runs: the
    update skipped (``"zero"``: lr 0) or flipped (``"sign"``: −lr), or
    every rank's gradient block cut at its model neighbour's coordinates
    (``"swap"``: a misplaced reduce-scatter block); None plants none."""
    from repro_torch.training import train as ttrain
    saved = ttrain.adamw_update, ttrain.shard_of
    if fault in ("zero", "sign"):
        scale = 0.0 if fault == "zero" else -1.0
        ttrain.adamw_update = lambda g, st, p, lr: saved[0](
            g, st, p, lr=scale * lr)
    elif fault == "swap":
        def shifted(x, dims, coords, mesh):
            n = mesh.size("model")
            return saved[1](x, dims, dict(
                coords, model=(coords["model"] + 1) % n), mesh)
        ttrain.shard_of = shifted
    elif fault is not None:
        raise ValueError(fault)
    try:
        yield
    finally:
        ttrain.adamw_update, ttrain.shard_of = saved


def local_sharded_step(cfg, mesh, params, opt, batch, **step):
    """``make_train_step(mesh=mesh, **step)``'s step for every rank of the
    (data, model) ``mesh`` in one process, on the whole ``params`` and
    ``opt`` (in place), with the ranks' sums in the ranks' order: each
    data shard's gradients from the mesh-less step (on a copy, its update
    dropped), their mean, the whole-tree norm from each rank's owned
    shards added in rank order, the clip and the AdamW update. The gloo
    ranks are held bitwise to it. → (params, opt, {"loss", "grad_norm",
    "lr"})."""
    import itertools

    from repro_torch.distributed.partitioning import shard_of
    from repro_torch.training.optimizer import (adamw_init, adamw_update,
                                                clip_by_global_norm,
                                                warmup_cosine)
    from repro_torch.training.train import (make_train_step, ordered_sum,
                                            shard_dims, tree_sumsq)
    from repro_torch.tree_util import flatten_with_path, tree_map, unflatten
    n = mesh.size("data")
    rows = batch["tokens"].shape[0] // n
    grads, losses = [], []

    def keep(g):
        grads.append(tree_map(torch.clone, g))
        return g
    for i in range(n):
        copy = tree_map(torch.clone, params)
        _, _, m = make_train_step(cfg, compress_grads=keep, **step)(
            copy, adamw_init(copy), {k: v[i * rows:(i + 1) * rows]
                                     for k, v in batch.items()})
        losses.append(m["loss"])
        del copy
    div = torch.full((), float(n), device=losses[0].device)

    def mean(xs):
        return ordered_sum(xs) / div if n > 1 else xs[0]
    grads = tree_map(lambda *g: mean(g), *grads)
    dims = shard_dims(cfg, params, mesh)
    coords = [dict(zip(mesh.axis_names, c)) for c in itertools.product(
        *(range(int(mesh.shape[a])) for a in mesh.axis_names))]
    norm = torch.sqrt(ordered_sum([tree_sumsq(unflatten(grads, [
        shard_of(x, dims[path], c, mesh)
        for path, x in flatten_with_path(grads)]), dims, c, mesh)
        for c in coords]))
    grads, _ = clip_by_global_norm(grads, step["max_grad_norm"], norm=norm)
    lr = warmup_cosine(opt.step + 1, peak_lr=step["peak_lr"],
                       warmup=step["warmup"], total=step["total_steps"])
    params, opt = adamw_update(grads, opt, params, lr=lr)
    return params, opt, {"loss": mean(losses), "grad_norm": norm, "lr": lr}
