#!/usr/bin/env python3
"""How bitnet-3b's QAT loss moves over 8 steps at a given peak lr, on the
card or against the JAX reference on the CPU.

    # on the card: chip_smoke.py's full-width arm (26 layers, batch 4 x
    # 512) at each lr:warmup; every step's loss is logged, and a run whose
    # loss does not fall raises the arm's gate and ends the script
    python3 scripts/train_lr_check.py --card 1e-4:1 3e-4:1 1e-3:1

    # on the CPU: the reference's train step and the port's from the
    # reference's masters, at bitnet-3b's width and 1 layer, batch 1 x 256
    PYTHONPATH=src python3 scripts/train_lr_check.py --cpu 1e-3 1e-4

Both print one line of 8 losses a run. The CPU mode imports the JAX
reference; the card mode does not.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
STEPS = 8


def card(runs) -> None:
    import numpy as np
    import torch

    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    for run in runs:
        lr, warmup = run.split(":")
        _, st = cs.train_full_arm(torch, np, smi, lr=float(lr),
                                  warmup=int(warmup))
        print(f"card lr {lr} warmup {warmup}: gate passed, losses "
              f"{st['losses']} [{smi}]", flush=True)
        cs.free_cuda(torch)


def cpu(lrs) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro.configs.bitnet_3b import CONFIG
    from repro.models.transformer import init_params as jinit
    from repro.training.optimizer import adamw_init as jadamw_init
    from repro.training.train import make_train_step as jmake_train_step
    from repro_torch.configs import get_config
    from repro_torch.convert import from_numpy_tree
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train import make_train_step

    jcfg = CONFIG.replace(n_layers=1)
    cfg = get_config("bitnet-3b").replace(n_layers=1)
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
            want.append(round(float(m["loss"]), 4))
        del params, opt
        tstep = make_train_step(cfg, peak_lr=lr, warmup=1, total_steps=STEPS)
        topt, got = adamw_init(tp), []
        for b in batches:
            tp, topt, m = tstep(tp, topt, {k: torch.from_numpy(v)
                                           for k, v in b.items()})
            got.append(round(float(m["loss"]), 4))
        print(f"cpu lr {lr}: reference {want}", flush=True)
        print(f"cpu lr {lr}: port      {got}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--card", nargs="*", default=[], metavar="LR:WARMUP")
    ap.add_argument("--cpu", nargs="*", default=[], metavar="LR")
    args = ap.parse_args()
    if args.card:
        card(args.card)
    if args.cpu:
        cpu(args.cpu)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
