"""Quickstart on the PyTorch port: the paper's pipeline on the card.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

1. Build a small BitNet-style model (any of the assigned archs works:
   swap the config import), its weights drawn from a seed.
2. Quantize to the deployment format: packed 2-bit ternary weights (TINT
   stream, the QKV projection fused into one) + absmax int8 activations.
3. Prefill with int8 flash attention, then decode with LOP predictive
   sparse attention (screen → comparison-free top-K → exact attention on
   the K candidate blocks), each step through the hand-written kernels.

Runs on the CUDA card unless ``--device cpu`` asks for the plain PyTorch
versions of the kernels.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.bitnet_3b import REDUCED as CFG
from repro_torch.core.lop import kv_traffic_bytes
from repro_torch.device import resolve_device
from repro_torch.serving.engine import prefill, serve_step
from repro_torch.serving.quantize import init_serving_params

PROMPTS, PROMPT_LEN, GEN = 4, 24, 16


def run(cfg, qp, device) -> dict:
    """Serve 4 seeded 24-token prompts on the deployed tree ``qp``: one
    whole prefill, then 16 greedy decode steps. Prints what the pipeline
    did. → {"continuation": int [4, 16], "kv_bytes": (dense, LOP)}."""
    wqkv = qp["layers"]["attn"]["wqkv"]
    print(f"QKV deployed as ONE packed uint8 {tuple(wqkv['packed'].shape)} "
          f"(2 bit/weight, fused at quantize time) + per-column γ")

    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (PROMPTS, PROMPT_LEN)).astype(np.int32)).to(device)
    logits, cache = prefill(cfg, qp, prompts, max_len=PROMPT_LEN + GEN)
    print(f"prefill done: cache holds {int(cache['lengths'][0])} tokens "
          f"(int8 K/V + f32 scales + packed 4-bit LOP features)")

    generated = []
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    for _ in range(GEN):
        generated.append(tok.cpu().numpy())
        logits, cache = serve_step(cfg, qp, cache, tok)
        tok = logits.argmax(-1)[:, None].to(torch.int32)
    out = np.concatenate(generated, axis=1)
    print("greedy continuation:\n", out)

    m = int(cache["lengths"][0])
    dense = kv_traffic_bytes(m, cfg.hd, m, with_lop=False)
    lop = kv_traffic_bytes(m, cfg.hd, int(cfg.lop_keep * m), with_lop=True)
    print(f"KV bytes/head/query: {dense} dense → {lop} with LOP "
          f"({dense / lop:.1f}×; paper's Fig. 8 regime counts only exact "
          f"K/V fetches: {dense / (2 * int(cfg.lop_keep * m) * cfg.hd):.1f}×)")
    return {"continuation": out, "kv_bytes": (dense, lop)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = CFG.replace(lop_keep=0.25)          # keep 25% of KV blocks
    print(f"model: {cfg.name} ({cfg.n_layers}L d={cfg.d_model}) "
          f"quant={cfg.quant} lop_keep={cfg.lop_keep}")
    # 1. seeded master weights, 2. the deployment format, drawn and
    # quantized one layer at a time
    qp = init_serving_params(cfg, 0, device)
    run(cfg, qp, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
