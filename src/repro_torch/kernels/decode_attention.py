"""CUDA decode attention wrappers (``csrc/decode_attention.cu``).

Two kernels replace the two bodies of the Pallas
``fused_decode_attention``:

* :func:`fused_decode_attention` — the LOP mode the serving path runs:
  LOP screen over the packed feature cache, comparison-free block top-K,
  exact int8 attention over the selected blocks, with ``window`` and
  ``pos_offset`` 0;
* :func:`fused_dense_decode_attention` — the dense mode
  (``use_lop=False``): exact int8 attention streamed over every valid
  K/V block. The ``--no-lop`` serve and every fault-recovery retry run it.

``shared_select``, a non-zero ``pos_offset`` and ``return_stats`` are not
ported to CUDA yet: the wrappers raise on them (the plain version in
``kernels/ref.py`` implements every mode).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.qlinear import _stream, require

SMEM_LIMIT = 232448          # bytes of shared memory one CTA may use


def _check_common(qi, qsc, k_cache, v_cache, k_scale, v_scale, new_len, *,
                  hkv: int, block: int):
    """Validate the operands both modes share. → (BH, G, M, d)."""
    require(qi, "qi", torch.int8)
    if qi.dim() != 3:
        raise ValueError(f"qi: expected [BH, G, d], got {tuple(qi.shape)}")
    bh, g, d = qi.shape
    m = k_cache.shape[1]
    if d % 4:
        raise ValueError(f"head dim {d} must be a multiple of 4")
    if block < 1 or m % block:
        raise ValueError(f"M={m} must be a multiple of block={block}")
    if bh % hkv:
        raise ValueError(f"BH={bh} is not a multiple of hkv={hkv}")
    require(qsc, "qsc", torch.float32, (bh, g))
    require(k_cache, "k_cache", torch.int8, (bh, m, d))
    require(v_cache, "v_cache", torch.int8, (bh, m, d))
    require(k_scale, "k_scale", torch.float32, (bh, m))
    require(v_scale, "v_scale", torch.float32, (bh, m))
    require(new_len, "new_len", torch.int32, (bh // hkv,))
    return bh, g, m, d


def _check_smem(smem: int) -> None:
    if smem > SMEM_LIMIT:
        raise ValueError(f"one CTA needs {smem} B of shared memory "
                         f"(limit {SMEM_LIMIT})")


def fused_decode_attention(qi, qsc, k_cache, v_cache, k_scale, v_scale, feat,
                           new_len, *, hkv: int, block: int, k_keep: int,
                           window: int, softmax_scale: float,
                           shared_select: bool = False, pos_offset: int = 0,
                           return_stats: bool = False) -> torch.Tensor:
    """LOP mode. qi int8 [BH, G, d], qsc f32 [BH, G], k/v int8 [BH, M, d],
    k/v scales f32 [BH, M], feat uint8 [BH, M, d/2], new_len int32 [B] →
    f32 [BH, G, d]."""
    if shared_select or pos_offset or return_stats:
        raise NotImplementedError(
            "the CUDA LOP decode kernel runs shared_select=False, "
            "pos_offset=0, return_stats=False only")
    lib = _build.load("decode_attention")
    bh, g, m, d = _check_common(qi, qsc, k_cache, v_cache, k_scale, v_scale,
                                new_len, hkv=hkv, block=block)
    if k_keep < 1:
        raise ValueError(f"k_keep={k_keep} must be ≥ 1")
    require(feat, "feat", torch.uint8, (bh, m, d // 2))
    _check_smem(lib.repro_decode_smem_bytes(g, m // block, d, block, k_keep))
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


def fused_dense_decode_attention(qi, qsc, k_cache, v_cache, k_scale, v_scale,
                                 new_len, *, hkv: int, block: int,
                                 window: int, softmax_scale: float,
                                 pos_offset: int = 0,
                                 return_stats: bool = False) -> torch.Tensor:
    """Dense mode. qi int8 [BH, G, d], qsc f32 [BH, G], k/v int8
    [BH, M, d], k/v scales f32 [BH, M], new_len int32 [B] → f32
    [BH, G, d]; a lane's output depends on that lane's inputs alone."""
    if pos_offset or return_stats:
        raise NotImplementedError(
            "the CUDA dense decode kernel runs pos_offset=0, "
            "return_stats=False only")
    lib = _build.load("decode_attention")
    bh, g, m, d = _check_common(qi, qsc, k_cache, v_cache, k_scale, v_scale,
                                new_len, hkv=hkv, block=block)
    _check_smem(lib.repro_dense_decode_smem_bytes(g, d, block))
    out = torch.empty((bh, g, d), dtype=torch.float32, device=qi.device)
    if bh:
        rc = lib.repro_dense_decode_attention(
            qi.data_ptr(), qsc.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
            new_len.data_ptr(), out.data_ptr(), bh, g, m, d, hkv, block,
            int(window), float(softmax_scale), _stream(qi))
        _build.check(rc, "repro_dense_decode_attention")
        fused_dense_decode_attention.launches += 1
    return out


fused_dense_decode_attention.launches = 0
