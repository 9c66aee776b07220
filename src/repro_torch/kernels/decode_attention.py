"""CUDA decode attention wrappers (``csrc/decode_attention.cu``, on the
split-lane decode core ``csrc/int8_decode.cuh``).

Two kernels replace the two bodies of the Pallas
``fused_decode_attention``:

* :func:`fused_decode_attention` — the LOP mode the serving path runs:
  LOP screen over the packed feature cache, comparison-free block top-K,
  exact int8 attention over the selected blocks, with ``window`` and
  ``pos_offset`` 0;
* :func:`fused_dense_decode_attention` — the dense mode
  (``use_lop=False``): exact int8 attention streamed over every valid
  K/V block. The ``--no-lop`` serve and every fault-recovery retry run it.

Each (batch·kv-head) lane runs on a cluster of CTAs whose count depends on
the lane's shape alone (:func:`launch_shape`), so a lane's output is
bitwise the same whatever the other lanes hold and at any batch size.
One call is one launch from one C entry, with no scratch; the launch plan
is computed once per shape. ``shared_select``, a non-zero ``pos_offset``
and ``return_stats`` are not ported to CUDA yet: the wrappers raise on
them (the plain version in ``kernels/ref.py`` implements every mode).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.qlinear import _stream, require

SMEM_LIMIT = 232448          # bytes of shared memory one CTA may use
MAX_D = 256                  # head dims a lane's value sum covers


def _check_common(qi, qsc, k_cache, v_cache, k_scale, v_scale, new_len, *,
                  hkv: int, block: int):
    """Validate the operands both modes share. → (BH, G, M, d)."""
    require(qi, "qi", torch.int8)
    if qi.dim() != 3:
        raise ValueError(f"qi: expected [BH, G, d], got {tuple(qi.shape)}")
    bh, g, d = qi.shape
    m = k_cache.shape[1]
    if d % 4 or d > MAX_D:
        raise ValueError(f"head dim {d} must be a multiple of 4, ≤ {MAX_D}")
    if block < 8 or block % 8 or m % block:
        raise ValueError(f"M={m} must be a multiple of block={block}, and "
                         f"block a multiple of 8")
    if bh % hkv:
        raise ValueError(f"BH={bh} is not a multiple of hkv={hkv}")
    require(qsc, "qsc", torch.float32, (bh, g))
    require(k_cache, "k_cache", torch.int8, (bh, m, d))
    require(v_cache, "v_cache", torch.int8, (bh, m, d))
    require(k_scale, "k_scale", torch.float32, (bh, m))
    require(v_scale, "v_scale", torch.float32, (bh, m))
    require(new_len, "new_len", torch.int32, (bh // hkv,))
    _check_aligned(k_cache=k_cache, v_cache=v_cache, k_scale=k_scale,
                   v_scale=v_scale)
    return bh, g, m, d


def _check_aligned(**tensors) -> None:
    """The kernels stream these with 16-byte copies."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data must be 16-byte aligned")


def _check_smem(smem: int) -> None:
    if smem > SMEM_LIMIT:
        raise ValueError(f"one CTA needs {smem} B of shared memory "
                         f"(limit {SMEM_LIMIT})")


@functools.lru_cache(maxsize=None)
def _plan(g: int, nb: int, d: int, block: int, k_keep: int,
          lop: bool) -> dict:
    """The launch plan of one lane shape (checked once)."""
    info = (ctypes.c_int * 4)()
    _build.check(_build.load("decode_attention").repro_decode_plan(
        g, nb, d, block, k_keep, int(lop), ctypes.addressof(info)),
        "repro_decode_plan")
    plan = dict(zip(("split", "share", "warps", "smem"), info))
    _check_smem(plan["smem"])
    return plan


def launch_shape(bh: int, g: int, m: int, d: int, block: int, *,
                 k_keep: int = 0, lop: bool = True) -> dict:
    """CTAs, warps per CTA, dynamic shared-memory bytes, CTAs a lane
    (``split``, one cluster) and blocks a CTA (``share``) of one call over
    ``bh`` lanes of G = ``g`` query rows, capacity ``m``, head dim ``d``;
    and what the card holds of that launch at once (``resident_clusters``,
    ``ctas_per_sm``), which the plan never depends on."""
    args = (g, m // block, d, block, k_keep if lop else 0, lop)
    plan = _plan(*args)
    occ = (ctypes.c_int * 2)()
    _build.check(_build.load("decode_attention").repro_decode_occupancy(
        *args[:5], int(lop), ctypes.addressof(occ)), "repro_decode_occupancy")
    return dict(ctas=bh * plan["split"], warps=plan["warps"],
                smem=plan["smem"], split=plan["split"], share=plan["share"],
                resident_clusters=occ[0], ctas_per_sm=occ[1])


def fused_decode_attention(qi, qsc, k_cache, v_cache, k_scale, v_scale, feat,
                           new_len, *, hkv: int, block: int, k_keep: int,
                           window: int, softmax_scale: float,
                           shared_select: bool = False, pos_offset: int = 0,
                           return_stats: bool = False) -> torch.Tensor:
    """LOP mode. qi int8 [BH, G, d], qsc f32 [BH, G], k/v int8 [BH, M, d],
    k/v scales f32 [BH, M], feat uint8 [BH, M, d/2], new_len int32 [B] →
    f32 [BH, G, d]; a lane's output depends on that lane's inputs alone."""
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
    _check_aligned(feat=feat)
    _plan(g, m // block, d, block, k_keep, True)
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
    _plan(g, m // block, d, block, 0, False)
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
