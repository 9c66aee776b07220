"""End-to-end driver on the PyTorch port: QAT-train a ~100M-param BitNet
b1.58 model for a few hundred steps on the synthetic pipeline, with
checkpoint/restart.

    PYTHONPATH=src python examples/torch_train_bitnet.py [--steps 300] \\
        [--device cpu]

The config is a scaled BitNet (12L, d=768) — every projection a BitLinear
trained with STE; loss decreasing proves the QAT flow learns through the
ternary forward. SIGTERM checkpoints and exits; a second run with the same
``--ckpt-dir`` resumes from the last checkpoint. Trains on the CUDA card
unless ``--device cpu`` is given.
"""
import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.fault_tolerance import PreemptionHandler
from repro_torch.launch.train import train_loop

CFG_100M = ModelConfig(
    name="bitnet-100m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=2048,
    vocab=8192,
    head_dim=64,
)
CKPT_EVERY = 100


def n_params(cfg) -> int:
    return (cfg.vocab_padded * cfg.d_model * 2
            + cfg.n_layers * (4 * cfg.d_model ** 2
                              + 3 * cfg.d_model * cfg.d_ff))


def train(cfg, *, steps: int, global_batch: int, seq: int, ckpt_dir: str,
          device=None, ckpt_every: int = CKPT_EVERY,
          preemption=None) -> dict:
    """Train ``cfg`` from seed 0 (or resume from the last checkpoint in
    ``ckpt_dir``), a checkpoint every ``ckpt_every`` steps. → the
    training loop's stats."""
    device = resolve_device(device)
    if device.type == "cuda":
        # f32 products in full f32; bf16 products summed in f32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    print(f"training {cfg.name}: ~{n_params(cfg) / 1e6:.0f}M params, "
          f"{steps} steps, batch {global_batch} × seq {seq}")
    return train_loop(
        cfg, steps=steps, global_batch=global_batch, seq_len=seq,
        ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, peak_lr=6e-4,
        preemption=preemption, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "bitnet100m_ckpt_torch"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    out = train(CFG_100M, steps=args.steps, global_batch=args.global_batch,
                seq=args.seq, ckpt_dir=args.ckpt_dir, device=args.device,
                preemption=PreemptionHandler())
    first, last = np.mean(out["losses"][:10]), np.mean(out["losses"][-10:])
    print(f"loss {first:.3f} → {last:.3f}; "
          f"straggler summary: {out['straggler']}")
    assert last < first, "QAT did not learn"
    print("OK — checkpoints in", args.ckpt_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
