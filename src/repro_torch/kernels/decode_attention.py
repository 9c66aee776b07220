"""CUDA LOP-sparse decode attention wrapper (``csrc/decode_attention.cu``).

Replaces the Pallas ``fused_decode_attention`` in the mode the serving path
runs: LOP screen over the packed feature cache, comparison-free block
top-K, exact int8 attention over the selected blocks, with ``window`` and
``pos_offset`` 0. The dense mode (``use_lop=False``), ``shared_select``,
a non-zero ``pos_offset`` and ``return_stats`` are not ported to CUDA yet:
the wrapper raises on them (the plain version in ``kernels/ref.py``
implements every mode).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.qlinear import _stream, require

SMEM_LIMIT = 232448          # bytes of shared memory one CTA may use


def fused_decode_attention(qi, qsc, k_cache, v_cache, k_scale, v_scale, feat,
                           new_len, *, hkv: int, block: int, k_keep: int,
                           window: int, softmax_scale: float,
                           use_lop: bool = True, shared_select: bool = False,
                           pos_offset: int = 0,
                           return_stats: bool = False) -> torch.Tensor:
    """qi int8 [BH, G, d], qsc f32 [BH, G], k/v int8 [BH, M, d], k/v scales
    f32 [BH, M], feat uint8 [BH, M, d/2], new_len int32 [B] →
    f32 [BH, G, d]."""
    if not use_lop or shared_select or pos_offset or return_stats:
        raise NotImplementedError(
            "the CUDA decode kernel runs the LOP mode only (use_lop=True, "
            "shared_select=False, pos_offset=0, return_stats=False)")
    lib = _build.load("decode_attention")
    require(qi, "qi", torch.int8)
    if qi.dim() != 3:
        raise ValueError(f"qi: expected [BH, G, d], got {tuple(qi.shape)}")
    bh, g, d = qi.shape
    m = k_cache.shape[1]
    if d % 4:
        raise ValueError(f"head dim {d} must be a multiple of 4")
    if m % block or not 1 <= k_keep:
        raise ValueError(f"M={m} must be a multiple of block={block}, "
                         f"k_keep={k_keep} ≥ 1")
    if bh % hkv:
        raise ValueError(f"BH={bh} is not a multiple of hkv={hkv}")
    require(qsc, "qsc", torch.float32, (bh, g))
    require(k_cache, "k_cache", torch.int8, (bh, m, d))
    require(v_cache, "v_cache", torch.int8, (bh, m, d))
    require(k_scale, "k_scale", torch.float32, (bh, m))
    require(v_scale, "v_scale", torch.float32, (bh, m))
    require(feat, "feat", torch.uint8, (bh, m, d // 2))
    require(new_len, "new_len", torch.int32, (bh // hkv,))
    smem = lib.repro_decode_smem_bytes(g, m // block, d, block, k_keep)
    if smem > SMEM_LIMIT:
        raise ValueError(f"decode lane needs {smem} B of shared memory "
                         f"(limit {SMEM_LIMIT})")
    out = torch.empty((bh, g, d), dtype=torch.float32, device=qi.device)
    if bh:
        rc = lib.repro_lop_decode_attention(
            qi.data_ptr(), qsc.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
            feat.data_ptr(), new_len.data_ptr(), out.data_ptr(), bh, g, m, d,
            hkv, block, k_keep, int(window), float(softmax_scale), _stream(qi))
        _build.check(rc, "repro_lop_decode_attention")
        fused_decode_attention.launches += 1
    return out


fused_decode_attention.launches = 0
