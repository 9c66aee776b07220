"""The QAT training step: BitNet's STE forward, cross entropy (+ the MoE
aux loss), gradient accumulation over microbatches, global-norm clipping,
warmup-cosine AdamW — the reference's ``training/train.py``.

The step runs in place: gradients land in each master's ``.grad`` (a
stacked leaf's layer by layer, :func:`repro_torch.models.transformer.
_scan_stack`), accumulate there over microbatches (the first
microbatch's gradients, then each later one added, as the reference's
sum from zero), and are dropped after the update, so a step holds the
masters, one set of gradients and the two moments.
"""

from __future__ import annotations

import torch

from repro_torch.models.transformer import forward_train
from repro_torch.training.optimizer import (adamw_update,
                                            clip_by_global_norm,
                                            global_norm, warmup_cosine)
from repro_torch.tree_util import leaves, tree_map

AUX_WEIGHT = 0.01           # MoE load-balance loss weight


def loss_fn(cfg, params, batch, *, remat: bool = True):
    """Causal-LM cross entropy (+ MoE aux). batch: tokens/labels [B, T]
    (and frames or patches). → (loss, {"ce", "aux"})."""
    logits, aux = forward_train(
        cfg, params, batch["tokens"], frames=batch.get("frames"),
        patches=batch.get("patches"), remat=remat)
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
                    remat: bool = True):
    """→ ``train_step(params, opt_state, batch) → (params, opt_state,
    metrics)``: params and the moments updated in place, metrics 0-d
    tensors on the device (loss, grad_norm, lr, param_norm, ce, aux).

    ``compress_grads`` is an optional hook, gradient tree → gradient
    tree, called before clipping."""

    def train_step(params, opt_state, batch):
        masters = leaves(params)
        for p in masters:
            p.grad = None
            p.requires_grad_(True)
        try:
            losses, parts = [], []
            for mb in ([batch] if n_micro == 1
                       else _microbatches(batch, n_micro)):
                loss, part = loss_fn(cfg, params, mb, remat=remat)
                loss.backward()
                losses.append(loss.detach())
                parts.append({k: v.detach() for k, v in part.items()})
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
            if compress_grads is not None:
                grads = compress_grads(grads)
            grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
            # the schedule indexed by the step being taken (1-based)
            lr = warmup_cosine(opt_state.step + 1, peak_lr=peak_lr,
                               warmup=warmup, total=total_steps)
            params, opt_state = adamw_update(grads, opt_state, params, lr=lr)
            for p in masters:
                p.grad = None
            metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr,
                       "param_norm": global_norm(params), **part}
        return params, opt_state, metrics

    return train_step
