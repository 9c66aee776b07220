"""End-to-end QAT training driver with checkpoint/restart and preemption:

    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --steps 200 --global-batch 8 --seq 128 [--device cpu] \\
        [--ckpt-dir DIR]

The reference's ``launch/train.py`` with ``--device``: the synthetic
sharded data pipeline, the QAT step (STE ternary weights, absmax int8
activations), gradient accumulation, warmup-cosine AdamW, step-level
checkpoints (atomic manifests) and resume, SIGTERM → checkpoint and a
clean exit, and straggler monitoring. Without ``--device`` it trains on
the CUDA card and raises where there is none. Every family trains,
the recurrent ones too (``--arch rwkv6-1.6b``,
``--arch jamba-1.5-large-398b --reduced``).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint.store import (latest_step, load_checkpoint,
                                          save_checkpoint)
from repro_torch.configs import resolve_config
from repro_torch.data.pipeline import SyntheticDataset
from repro_torch.device import resolve_device
from repro_torch.distributed.fault_tolerance import (PreemptionHandler,
                                                     StragglerMonitor)
from repro_torch.models.transformer import init_params
from repro_torch.training.optimizer import adamw_init
from repro_torch.training.train import make_train_step


def train_loop(cfg, *, steps: int, global_batch: int, seq_len: int,
               ckpt_dir: str | None = None, ckpt_every: int = 50,
               n_micro: int = 1, peak_lr: float = 1e-3, seed: int = 0,
               log_every: int = 10, preemption=None, resume: bool = True,
               hooks=None, device=None, params=None) -> dict:
    """Train ``steps`` steps from masters drawn with ``seed`` (or the
    given ``params``, which are updated in place) on ``device``.
    → {"losses": [...], "last_step": n, "straggler": summary, "params":
    the masters, "opt_state": the AdamW state}."""
    device = resolve_device(device)
    data = SyntheticDataset(cfg, seq_len=seq_len, global_batch=global_batch,
                            seed=seed)
    if params is None:
        params = init_params(cfg, seed, device)
    opt_state = adamw_init(params)
    start = 0
    if ckpt_dir and resume and latest_step(ckpt_dir) is not None:
        (params, opt_state), start, _ = load_checkpoint(
            ckpt_dir, (params, opt_state))
        print(f"resumed from step {start}")

    step_fn = make_train_step(cfg, n_micro=n_micro, peak_lr=peak_lr,
                              warmup=max(steps // 10, 1), total_steps=steps)
    monitor = StragglerMonitor()
    losses = []
    n, saved = start, None          # the step last checkpointed, once each
    for n in range(start, steps):
        t0 = time.time()
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.batch(n).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])             # waits for the step
        losses.append(loss)
        straggle = monitor.record(time.time() - t0)
        if n % log_every == 0:
            print(f"step {n:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e}"
                  + ("  [straggler]" if straggle else ""))
        if hooks:
            for h in hooks:
                h(n, params, opt_state, metrics)
        if ckpt_dir and (n + 1) % ckpt_every == 0:
            save_checkpoint(ckpt_dir, n + 1, (params, opt_state))
            saved = n + 1
        if preemption is not None and preemption.preempted:
            print(f"preempted at step {n + 1}: checkpointed, exiting")
            break
    if ckpt_dir and saved != n + 1:
        save_checkpoint(ckpt_dir, n + 1, (params, opt_state))
    return {"losses": losses, "last_step": n + 1,
            "straggler": monitor.summary(), "params": params,
            "opt_state": opt_state}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="bitnet-3b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced config (CPU-scale)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if device.type == "cuda":
        # f32 products in full f32; bf16 products summed in f32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    cfg = resolve_config(args.arch, args.reduced)
    print(f"training {cfg.name} ({cfg.family}) for {args.steps} steps, "
          f"batch {args.global_batch} × seq {args.seq} on {device}")
    pre = PreemptionHandler()
    out = train_loop(cfg, steps=args.steps, global_batch=args.global_batch,
                     seq_len=args.seq, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every, n_micro=args.n_micro,
                     peak_lr=args.lr, seed=args.seed, preemption=pre,
                     device=device)
    first = np.mean(out["losses"][:10])
    last = np.mean(out["losses"][-10:])
    print(f"loss {first:.4f} → {last:.4f} over {out['last_step']} steps")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
