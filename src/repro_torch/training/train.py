"""The QAT training step: BitNet's STE forward, cross entropy (+ the MoE
aux loss), gradient accumulation over microbatches, global-norm clipping,
warmup-cosine AdamW — the reference's ``training/train.py``.

The step runs in place: gradients land in each master's ``.grad`` (a
stacked leaf's layer by layer, :func:`repro_torch.models.transformer.
_scan_stack`), accumulate there over microbatches (the first
microbatch's gradients, then each later one added, as the reference's
sum from zero), and are dropped after the update, so a step holds the
masters, one set of gradients and the two moments.

On a (data, model) mesh (``make_train_step(mesh=, dims=)``) each rank
holds its shard of every master, gradient and moment under the
reference's partition specs
(:func:`repro_torch.models.transformer.param_specs`, resolved by
:func:`shard_dims`), and its data-parallel shard of the batch.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.partitioning import (all_gather, dp_axes,
                                                  leaf_dims, owns, psum,
                                                  psum_scatter, shard_of)
from repro_torch.models.transformer import (_STACKS, forward_train,
                                            param_specs)
from repro_torch.training.optimizer import (_blocks, adamw_update,
                                            clip_by_global_norm,
                                            global_norm, warmup_cosine)
from repro_torch.tree_util import (flatten_with_path, leaves, tree_map,
                                   unflatten)

AUX_WEIGHT = 0.01           # MoE load-balance loss weight


def loss_fn(cfg, params, batch, *, remat: bool = True, gather=None):
    """Causal-LM cross entropy (+ MoE aux). batch: tokens/labels [B, T]
    (and frames or patches). → (loss, {"ce", "aux"}). ``gather``:
    :func:`forward_train`'s."""
    logits, aux = forward_train(
        cfg, params, batch["tokens"], frames=batch.get("frames"),
        patches=batch.get("patches"), remat=remat, gather=gather)
    # vocab padding out of the softmax
    vmask = torch.arange(cfg.vocab_padded, device=logits.device) < cfg.vocab
    logits = torch.where(vmask, logits, -1e30)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.gather(logp, -1, batch["labels"][..., None].long())[..., 0]
    ce = -ll.mean()
    return ce + AUX_WEIGHT * aux, {"ce": ce, "aux": aux}


def _microbatches(batch, n_micro: int) -> list:
    return [{k: a[j * (a.shape[0] // n_micro):(j + 1) * (a.shape[0]
                                                          // n_micro)]
             for k, a in batch.items()} for j in range(n_micro)]


def make_train_step(cfg, *, n_micro: int = 1, peak_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10_000,
                    max_grad_norm: float = 1.0, compress_grads=None,
                    remat: bool = True, mesh=None, dims: dict | None = None):
    """→ ``train_step(params, opt_state, batch) → (params, opt_state,
    metrics)``: params and the moments updated in place, metrics 0-d
    tensors on the device (loss, grad_norm, lr, param_norm, ce, aux).

    ``compress_grads`` is an optional hook, gradient tree → gradient
    tree, called before clipping.

    With ``mesh`` (a process group's; ``dims`` from :func:`shard_dims`)
    ``params`` and the moments are this rank's shards
    (:func:`shard_tree`) and ``batch`` the global batch, of which the
    rank takes its data-parallel shard. Each layer's leaves are gathered
    inside its remat, and each gradient is averaged over the data axes
    and cut back to this rank's shard as the backward reaches it; the
    compute repeats across the model axis. The loss is the mean of the
    data shards' losses; the grad norm and the clip cover the whole
    tree."""
    if mesh is None:
        gather, norm = None, global_norm
    else:
        def gather(tree, name):
            strip = 1 if name in _STACKS else 0
            return unflatten(tree, [
                _Gather.apply(x, dims[path][strip:], mesh)
                for path, x in flatten_with_path(tree, f"[{name!r}]")])

        def norm(tree):
            return _global_norm(tree, dims, mesh)

    def train_step(params, opt_state, batch):
        if mesh is not None:
            batch = _dp_shard(batch, mesh)
        masters = leaves(params)
        for p in masters:
            p.grad = None
            p.requires_grad_(True)
        try:
            losses, parts = [], []
            tr, repeat = _tracing(masters, n_micro), None
            for j, mb in enumerate([batch] if n_micro == 1
                                   else _microbatches(batch, n_micro)):
                if repeat is not None:
                    # the dry-run's trace: the second microbatch's cost
                    tr.absorb(repeat)
                    losses.append(losses[-1])
                    parts.append(parts[-1])
                    continue
                snap = tr.snapshot() if tr is not None else None
                loss, part = loss_fn(cfg, params, mb, remat=remat,
                                     gather=gather)
                loss.backward()
                losses.append(loss.detach())
                parts.append({k: v.detach() for k, v in part.items()})
                if tr is not None and j == 1:
                    repeat = tr.since(snap)
        finally:
            for p in masters:
                p.requires_grad_(False)
        with torch.no_grad():
            # a master the loss does not reach gets zeros (jax.grad's)
            grads = tree_map(lambda p: torch.zeros_like(p) if p.grad is None
                             else p.grad, params)
            if n_micro == 1:
                loss, part = losses[0], parts[0]
            else:
                n = torch.full((), float(n_micro), device=losses[0].device)
                loss = sum(losses) / n
                for g in leaves(grads):
                    g.div_(n)
                part = {k: torch.stack([q[k] for q in parts]).mean()
                        for k in parts[0]}
            if mesh is not None:
                loss = _dp_mean(loss, mesh)
                part = {k: _dp_mean(v, mesh) for k, v in part.items()}
            if compress_grads is not None:
                grads = compress_grads(grads)
            grads, gnorm = clip_by_global_norm(grads, max_grad_norm,
                                               norm=norm(grads))
            # the schedule indexed by the step being taken (1-based)
            lr = warmup_cosine(opt_state.step + 1, peak_lr=peak_lr,
                               warmup=warmup, total=total_steps)
            params, opt_state = adamw_update(grads, opt_state, params, lr=lr)
            for p in masters:
                p.grad = None
            metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr,
                       "param_norm": norm(params), **part}
        return params, opt_state, metrics

    return train_step


def _tracing(masters, n_micro: int):
    """The active dry-run trace when the step's microbatches past the
    second are replayed: meta masters and three or more microbatches.
    Each of them runs the second's program on the same shapes (the
    gradients already allocated, accumulated in place), so its cost is
    the second's, recorded without running it again, and the peak is
    the second's; a full-width step of 8 meta microbatches would take
    minutes (a meta op costs ~0.2 ms)."""
    if n_micro < 3 or masters[0].device.type != "meta":
        return None
    from repro_torch.analysis import op_trace
    return op_trace.current()


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------

def shard_dims(cfg, params, mesh) -> dict:
    """{keystr path: the leaf's cut dims on ``mesh``} for the master tree
    ``params`` (or any tree of its shapes): the reference's partition
    specs with its rule that an axis whose size does not divide the dim
    drops to replicated."""
    specs = dict(_spec_paths(param_specs(cfg, params)))
    return {path: leaf_dims(specs[path], leaf.shape, mesh)
            for path, leaf in flatten_with_path(params)}


def _spec_paths(tree, prefix: str = ""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _spec_paths(tree[k], f"{prefix}[{k!r}]")
        else:
            yield f"{prefix}[{k!r}]", tree[k]


def shard_tree(tree, dims: dict, mesh):
    """This rank's shard of every leaf of the whole ``tree`` (or of each
    master-shaped tree of a NamedTuple such as an AdamW state)."""
    coords = mesh.coords()
    return _map_paths(lambda path, x: shard_of(x, dims[path], coords, mesh),
                      tree)


def gather_tree(tree, dims: dict, mesh):
    """The whole tree from every rank's shards (collective: every rank of
    the mesh calls it)."""
    return _map_paths(lambda path, x: _gathered(x, dims[path], mesh), tree)


def _map_paths(fn, tree):
    """``fn(master path, leaf)`` over a master-shaped tree, or over each
    such tree of a NamedTuple (a field that is not a dict, such as a step
    count, is kept)."""
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map_paths(fn, v) if isinstance(v, dict) else v
                            for v in tree))
    return unflatten(tree, [fn(path, x)
                            for path, x in flatten_with_path(tree)])


def _gathered(x, dims, mesh):
    for i, axes in enumerate(dims):
        if axes:
            x = all_gather(x, axes, i, mesh)
    return x.contiguous()


def _dp(mesh) -> tuple:
    """The mesh's data-parallel axes."""
    return tuple(a for a in dp_axes(mesh) if a in mesh.axis_names)


def _dp_mean(x, mesh):
    """x averaged over the data-parallel axes (the sum over their ranks
    divided by their count)."""
    axes = _dp(mesh)
    n = mesh.size(axes)
    if n == 1:
        return x
    return psum(x, axes, mesh) / torch.full((), float(n), device=x.device)


class _Gather(torch.autograd.Function):
    """A rank's shard → the whole leaf (all-gathered over each cut dim's
    axes). Its gradient: the whole leaf's gradient averaged over the
    data-parallel axes, then this rank's shard of it (the ranks along
    the model axis compute the same gradient); a leaf cut over the data
    axes takes its block by a reduce-scatter, half an all-reduce."""

    @staticmethod
    def forward(ctx, x, dims, mesh):
        ctx.dims, ctx.mesh = dims, mesh
        out = _gathered(x, dims, mesh)
        # a replicated leaf comes back whole: a copy, not the input itself
        return out.clone() if out is x else out

    @staticmethod
    def backward(ctx, grad):
        mesh, dims = ctx.mesh, ctx.dims
        dp = _dp(mesh)
        n = mesh.size(dp)
        cut = [i for i, axes in enumerate(dims) if axes == dp]
        if n == 1 or not cut:
            grad = _dp_mean(grad.contiguous(), mesh)
        else:
            grad = psum_scatter(grad.contiguous(), dp, cut[0], mesh) / \
                torch.full((), float(n), device=grad.device)
            dims = tuple(None if i == cut[0] else axes
                         for i, axes in enumerate(dims))
        return shard_of(grad, dims, mesh.coords(), mesh), None, None


def _dp_shard(batch, mesh):
    """This rank's data-parallel shard of the global ``batch``; a batch
    whose size the data axes do not divide stays whole on every rank (the
    reference's rule for an axis that does not divide)."""
    n, i = mesh.size(_dp(mesh)), mesh.rank(_dp(mesh))
    return {k: a if a.shape[0] % n else
            a[i * (a.shape[0] // n):(i + 1) * (a.shape[0] // n)]
            for k, a in batch.items()}


def tree_sumsq(tree, dims: dict, coords: dict, mesh):
    """Σ over the leaves (the reference's leaf order) of the f32 sum of
    squares of the shards ``tree`` of the rank at ``coords``, each leaf
    counted by one rank alone (:func:`owns`)."""
    total = torch.zeros((), dtype=torch.float32,
                        device=leaves(tree)[0].device)
    for path, x in flatten_with_path(tree):
        if owns(dims[path], coords, mesh):
            total = total + sum(torch.sum(torch.square(
                x[sl].to(torch.float32))) for sl in _blocks(x))
    return total


def ordered_sum(xs):
    """x0 + x1 + … in that order."""
    total = xs[0]
    for x in xs[1:]:
        total = total + x
    return total


def _global_norm(tree, dims: dict, mesh):
    """The whole tree's norm from the shards: each rank's owned sum of
    squares, gathered and added in rank order (so every rank adds the
    same numbers in the same order)."""
    own = tree_sumsq(tree, dims, mesh.coords(), mesh)
    return torch.sqrt(ordered_sum(all_gather(own.reshape(1), mesh.axis_names,
                                             0, mesh).unbind(0)))
