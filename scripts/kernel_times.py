"""Device times of the four decode-side kernels for one build of the port,
so two builds compare in one call.

    PYTHONPATH=<tree>/src python3 scripts/kernel_times.py [--rounds N]

At ``chip_smoke.py``'s shapes (bitnet-3b: 32 heads of 100, capacity 1664,
blocks of 128, K = 2), on inputs made from a seed:

  #4 fused_decode_attention and #5 fused_dense_decode_attention at B = 4,
     new_len [1600, 0, 700, 1200] (phase 3);
  #6 lop_scores_kernel over the 128 (B, Hkv) lanes and #9
     sparse_decode_attention over those lanes' ``select_blocks`` choices,
     new_len [1600, 1, 700, 1200] (phase 5).

Each is timed eager (CUDA events around 50 calls) and with 20 calls
captured in one CUDA graph (the device's time without the host's issue
time), inputs rotated over >100 MB of copies so L2 starts cold
(``chip_smoke.cuda_ms`` / ``graph_ms``), ``--rounds`` times in turn; the
line gives every round, the bound (``chip_smoke.bound_ms``) and a sha256 of
the kernel's output, so two builds that agree bitwise print the same
digest. ``repro_torch`` is imported from ``PYTHONPATH``; the wrappers'
signatures are the same in every build since the kernels were ported, so
the parent's and the change's ``src`` run this one script in one call
(parent, change, change, parent). Needs one CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import hashlib
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as smoke  # noqa: E402

H, DH, M, BLOCK, K_KEEP = 32, 100, 1664, 128, 2
DECODE_LEN = (1600, 0, 700, 1200)
PER_HEAD_LEN = smoke.PER_HEAD_LEN


def digest(torch, t) -> str:
    torch.cuda.synchronize()
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def cases(torch, np):
    """→ [(name, fn, args, bound ms)] for the four kernels."""
    from repro_torch.core.lop import lop_features, pack_features, pot
    from repro_torch.kernels import ref as plain
    from repro_torch.kernels.decode_attention import (
        fused_decode_attention, fused_dense_decode_attention)
    from repro_torch.kernels.int8_attention import sparse_decode_attention
    from repro_torch.kernels.lop_scores import lop_scores_kernel
    from repro_torch.serving.lop_select import select_blocks

    dev = torch.device("cuda")
    rng = np.random.default_rng(smoke.SEED + 20)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    b = len(DECODE_LEN)
    bh = b * H
    qi = t(rng.integers(-127, 128, (bh, 1, DH)).astype(np.int8))
    qsc = t((rng.random((bh, 1)) * 0.02 + 0.001).astype(np.float32))
    kd = t(rng.integers(-127, 128, (bh, M, DH)).astype(np.int8))
    vd = t(rng.integers(-127, 128, (bh, M, DH)).astype(np.int8))
    ksd = t((rng.random((bh, M)) * 0.02 + 0.001).astype(np.float32))
    vsd = t((rng.random((bh, M)) * 0.02 + 0.001).astype(np.float32))
    feat = pack_features(lop_features(kd))
    scale = DH ** -0.5
    out = []

    # #4 and #5 at phase 3's shape
    nl = torch.tensor(DECODE_LEN, dtype=torch.int32, device=dev)
    live = sum(min(n, K_KEEP * BLOCK) for n in DECODE_LEN if n)
    sel = sum(min(K_KEEP, -(-n // BLOCK)) for n in DECODE_LEN if n)
    b4, _ = smoke.bound_ms(
        smoke.nbytes(qi, qsc, nl) + H * sum(DECODE_LEN) * (DH // 2)
        + H * sel * BLOCK * (2 * DH + 8) + bh * DH * 4,
        int8_ops=2.0 * H * (sum(DECODE_LEN) + live) * DH,
        f32_ops=2.0 * H * live * DH)
    out.append(("#4 fused_decode_attention", lambda *a: fused_decode_attention(
        *a, hkv=H, block=BLOCK, k_keep=K_KEEP, window=0, softmax_scale=scale),
        (qi, qsc, kd, vd, ksd, vsd, feat, nl), b4))
    b5, _ = smoke.bound_ms(
        smoke.nbytes(qi, qsc, nl) + H * sum(DECODE_LEN) * (2 * DH + 8)
        + bh * DH * 4, int8_ops=2.0 * H * sum(DECODE_LEN) * DH,
        f32_ops=2.0 * H * sum(DECODE_LEN) * DH)
    out.append(("#5 fused_dense_decode_attention",
                lambda *a: fused_dense_decode_attention(
                    *a, hkv=H, block=BLOCK, window=0, softmax_scale=scale),
                (qi, qsc, kd, vd, ksd, vsd, nl), b5))

    # #6 over every lane, #9 over the lanes' selections (phase 5)
    q_pot = pot(qi).reshape(bh, 1, DH)
    b6, _ = smoke.bound_ms(smoke.nbytes(q_pot, feat) + bh * M * 4,
                           int8_ops=2.0 * bh * M * DH)
    out.append(("#6 lop_scores_kernel", lop_scores_kernel, (q_pot, feat), b6))
    nl5 = torch.tensor(PER_HEAD_LEN, dtype=torch.int32, device=dev)
    scores = plain.lop_scores_ref(q_pot, feat).reshape(b, H, 1, M)
    idx, gt = select_blocks(scores, nl5, block=BLOCK, k_keep=K_KEEP)
    nb = idx.shape[-1]
    idx, gt = (idx.reshape(bh, nb).contiguous(),
               gt.reshape(bh, 3 * nb).contiguous())
    gate = gt[:, :nb] > 0
    n_live = ((gt[:, nb:2 * nb] - gt[:, 2 * nb:]).clamp_min(0)
              * gate).sum().item()
    qs9 = qsc.reshape(bh, 1, 1)
    b9, _ = smoke.bound_ms(
        smoke.nbytes(qi, qs9, idx, gt) + n_live * (2 * DH + 8) + bh * DH * 4,
        int8_ops=2.0 * n_live * DH, f32_ops=2.0 * n_live * DH)
    out.append(("#9 sparse_decode_attention",
                lambda *a: sparse_decode_attention(*a, block=BLOCK,
                                                   softmax_scale=scale),
                (qi, kd, vd, qs9, ksd[..., None], vsd[..., None], idx, gt),
                b9))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    import repro_torch
    print(f"kernel_times: repro_torch from {Path(repro_torch.__file__).parent}"
          f" [{card}]", flush=True)
    for name, fn, a, b_ms in cases(torch, np):
        sets = smoke.copies(torch, a)
        eager, graph = [], []
        for _ in range(args.rounds):
            eager.append(smoke.cuda_ms(torch, fn, sets, 50))
            graph.append(smoke.graph_ms(torch, fn, sets))
        print(f"  {name}: eager {' / '.join(f'{x:.4f}' for x in eager)} ms, "
              f"graph {' / '.join(f'{x:.4f}' for x in graph)} ms, bound "
              f"{b_ms:.4f} ms ({b_ms / min(graph):.1%} in the graph); output "
              f"sha256 {digest(torch, fn(*a))} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
