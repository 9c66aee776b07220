#!/usr/bin/env python3
"""How a model's QAT loss moves at a given peak lr, on the card or
against the JAX reference on the CPU (bitnet-3b, or rwkv6-1.6b with
``--arch``).

    # on the card: chip_smoke.py's full-width arm (every layer, batch 4 x
    # 512 for bitnet-3b, 4 x 256 for rwkv6-1.6b, the arm's steps unless
    # --steps / --seq say otherwise) at each lr:warmup; every step's loss
    # and grad norm is logged, and a run whose last loss is not its lowest
    # raises the arm's gate and ends the script
    python3 scripts/train_lr_check.py --card 1e-4:1 3e-4:1 1e-3:1
    python3 scripts/train_lr_check.py --arch rwkv6-1.6b --card 3e-5:1

    # on the CPU: the reference's train step and the port's from the
    # reference's masters, at the model's width and 1 layer, batch 1 x 256
    PYTHONPATH=src python3 scripts/train_lr_check.py --cpu 1e-3 1e-4
    PYTHONPATH=src python3 scripts/train_lr_check.py --arch rwkv6-1.6b \
        --cpu 1e-4

Both print one line of 8 losses (and one of grad norms) a run. The CPU
mode imports the JAX reference; the card mode does not.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
STEPS = 8


def card(arch: str, runs, steps=None, seq=None) -> None:
    import numpy as np
    import torch

    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    arm = ({"steps": cs.REC_TRAIN_STEPS, "seq": cs.REC_TRAIN_SEQ}
           if arch == "rwkv6-1.6b" else {})
    arm.update({k: v for k, v in (("steps", steps), ("seq", seq)) if v})
    for run in runs:
        lr, warmup = run.split(":")
        _, st = cs.train_full_arm(torch, np, smi, lr=float(lr),
                                  warmup=int(warmup), arch=arch, **arm)
        print(f"card {arch} lr {lr} warmup {warmup} {arm}: gate passed, "
              f"losses {st['losses']}, grad norms {st['grad_norms']} "
              f"[{smi}]", flush=True)
        cs.free_cuda(torch)


def cpu(arch: str, lrs) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro.configs import get_config as jget_config
    from repro.models.transformer import init_params as jinit
    from repro.training.optimizer import adamw_init as jadamw_init
    from repro.training.train import make_train_step as jmake_train_step
    from repro_torch.configs import get_config
    from repro_torch.convert import from_numpy_tree
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train import make_train_step

    jcfg = jget_config(arch).replace(n_layers=1)
    cfg = get_config(arch).replace(n_layers=1)
    data = SyntheticDataset(cfg, seq_len=256, global_batch=1, seed=0)
    batches = [data.batch(n) for n in range(STEPS)]
    for lr in map(float, lrs):
        params = jax.jit(lambda k: jinit(jcfg, k)[0])(jax.random.PRNGKey(0))
        tp = from_numpy_tree(jax.tree.map(np.asarray, params), "cpu")
        step = jax.jit(jmake_train_step(jcfg, peak_lr=lr, warmup=1,
                                        total_steps=STEPS),
                       donate_argnums=(0, 1))
        opt, want = jadamw_init(params), []
        for b in batches:
            params, opt, m = step(params, opt, jax.tree.map(jnp.asarray, b))
            want.append((float(m["loss"]), float(m["grad_norm"])))
        del params, opt
        tstep = make_train_step(cfg, peak_lr=lr, warmup=1, total_steps=STEPS)
        topt, got = adamw_init(tp), []
        for b in batches:
            tp, topt, m = tstep(tp, topt, {k: torch.from_numpy(v)
                                           for k, v in b.items()})
            got.append((float(m["loss"]), float(m["grad_norm"])))
        for who, run in (("reference", want), ("port", got)):
            print(f"cpu {arch} lr {lr}: {who:9s} losses "
                  f"{[round(x[0], 4) for x in run]}, grad norms "
                  f"{[round(x[1], 2) for x in run]}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="bitnet-3b",
                    choices=("bitnet-3b", "rwkv6-1.6b"))
    ap.add_argument("--card", nargs="*", default=[], metavar="LR:WARMUP")
    ap.add_argument("--steps", type=int, help="card: steps a run")
    ap.add_argument("--seq", type=int, help="card: tokens a row")
    ap.add_argument("--cpu", nargs="*", default=[], metavar="LR")
    args = ap.parse_args()
    if args.card:
        card(args.arch, args.card, args.steps, args.seq)
    if args.cpu:
        cpu(args.arch, args.cpu)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
