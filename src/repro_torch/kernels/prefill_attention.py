"""CUDA chunked-prefill attention wrapper (``csrc/prefill_attention.cu``).

Replaces the Pallas ``fused_prefill_attention``: causal (or cross) int8
attention of a query chunk over the capacity-padded cache, with an online
softmax whose fully-masked positions fold to zero and whose flush divides
only where ℓ > 0. A query row's result depends on the row alone, so
chunked prefill stays bitwise whole-prompt prefill on the card.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.qlinear import _stream, require


def fused_prefill_attention(qi, qsc, k_cache, v_cache, k_scale, v_scale,
                            kv_len, q_off: int = 0, *, hkv: int, chunk: int,
                            causal: bool, window: int,
                            softmax_scale: float) -> torch.Tensor:
    """qi int8 [BH, R, d] (R = G·chunk, rows g-major), qsc f32 [BH, R],
    k/v int8 [BH, M, d], k/v scales f32 [BH, M], kv_len int32 [B] →
    f32 [BH, R, d]. ``q_off`` is the global position of chunk row 0."""
    lib = _build.load("prefill_attention")
    require(qi, "qi", torch.int8)
    if qi.dim() != 3:
        raise ValueError(f"qi: expected [BH, R, d], got {tuple(qi.shape)}")
    bh, r, d = qi.shape
    if d % 4 or d > lib.repro_prefill_max_d():
        raise ValueError(f"head dim {d} must be a multiple of 4 and at most "
                         f"{lib.repro_prefill_max_d()}")
    if r % chunk:
        raise ValueError(f"R={r} is not a multiple of chunk={chunk}")
    m = k_cache.shape[1]
    require(qsc, "qsc", torch.float32, (bh, r))
    require(k_cache, "k_cache", torch.int8, (bh, m, d))
    require(v_cache, "v_cache", torch.int8, (bh, m, d))
    require(k_scale, "k_scale", torch.float32, (bh, m))
    require(v_scale, "v_scale", torch.float32, (bh, m))
    require(kv_len, "kv_len", torch.int32, (bh // hkv,))
    if bh % hkv:
        raise ValueError(f"BH={bh} is not a multiple of hkv={hkv}")
    out = torch.empty((bh, r, d), dtype=torch.float32, device=qi.device)
    if bh and r:
        rc = lib.repro_prefill_attention(
            qi.data_ptr(), qsc.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
            kv_len.data_ptr(), out.data_ptr(), bh, r, m, d, hkv, chunk,
            int(q_off), int(bool(causal)), int(window), float(softmax_scale),
            _stream(qi))
        _build.check(rc, "repro_prefill_attention")
        fused_prefill_attention.launches += 1
        if not causal:
            _build.count_mode(fused_prefill_attention, "non_causal")
    return out


fused_prefill_attention.launches = 0
fused_prefill_attention.modes = {}


def launch_shape(bh: int, r: int, d: int) -> dict:
    """CTAs, warps per CTA and dynamic shared-memory bytes of one launch
    over ``bh`` lanes of ``r`` rows at head dim ``d``."""
    lib = _build.load("prefill_attention")
    rows = lib.repro_prefill_rows()
    return dict(ctas=bh * -(-r // rows), warps=lib.repro_prefill_warps(),
                smem=lib.repro_prefill_smem_bytes(d))
