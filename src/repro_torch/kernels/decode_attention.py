"""CUDA decode attention wrappers (``csrc/decode_attention.cu``, on the
split-lane decode core ``csrc/int8_decode.cuh``).

Two kernels replace the two bodies of the Pallas
``fused_decode_attention``:

* :func:`fused_decode_attention` — the LOP mode the serving path runs:
  LOP screen over the packed feature cache, comparison-free block top-K,
  exact int8 attention over the selected blocks; per query head, or with
  ``shared_select`` one candidate set per kv head (the group max of the
  screen), whose K blocks every row of the group attends;
* :func:`fused_dense_decode_attention` — the dense mode
  (``use_lop=False``): exact int8 attention streamed over every valid
  K/V block. The ``--no-lop`` serve and every fault-recovery retry run it.

Both take ``pos_offset`` (the global position of cache row 0, a multiple
of ``block``: a token shard of the sequence-parallel path, whose
``new_len`` stays the global length) and ``return_stats`` (also each
row's merged softmax max ``m`` and sum ``ℓ``, natural-log units, f32
[BH, G]; an empty row gives m = −1e30, ℓ = 0 and an exact-zero output),
as the Pallas kernel does.

Each (batch·kv-head) lane runs on a cluster of CTAs whose count depends on
the lane's shape alone (:func:`launch_shape`), so a lane's output is
bitwise the same whatever the other lanes hold and at any batch size.
One call is one launch from one C entry, with no scratch; the launch plan
is computed once per shape. ``stages`` (2, 3 or 4; 0 = 2) is the depth of
the kernels' ``cp.async`` ring, the tile sweep's knob
(:mod:`repro_torch.kernels.autotune`): it moves only how far ahead the
copies run, so every depth gives the same bits. The plain version in
``kernels/ref.py`` implements the same modes.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.analysis.roofline import SMEM_PER_CTA
from repro_torch.kernels import _build
from repro_torch.kernels.qlinear import _stream, require

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


def _check_offset(pos_offset: int, block: int) -> int:
    po = int(pos_offset)
    if po < 0 or po % block:
        raise ValueError(f"pos_offset={po} must be a non-negative multiple "
                         f"of block={block}")
    return po


def _outputs(bh: int, g: int, d: int, device, return_stats: bool):
    """out [BH, G, d] and, with ``return_stats``, m and ℓ [BH, G]; →
    (tensors, their pointers for the C entry: m and ℓ null without)."""
    out = torch.empty((bh, g, d), dtype=torch.float32, device=device)
    if not return_stats:
        return (out,), (out.data_ptr(), None, None)
    m = torch.empty((bh, g), dtype=torch.float32, device=device)
    l = torch.empty((bh, g), dtype=torch.float32, device=device)
    return (out, m, l), (out.data_ptr(), m.data_ptr(), l.data_ptr())


def _check_smem(smem: int) -> None:
    if smem > SMEM_PER_CTA:
        raise ValueError(f"one CTA needs {smem} B of shared memory "
                         f"(limit {SMEM_PER_CTA})")


@functools.lru_cache(maxsize=None)
def _plan(g: int, nb: int, d: int, block: int, k_keep: int, lop: bool,
          stages: int = 0) -> dict:
    """The launch plan of one lane shape and ring depth (checked once)."""
    info = (ctypes.c_int * 5)()
    _build.check(_build.load("decode_attention").repro_decode_plan(
        g, nb, d, block, k_keep, int(lop), stages, ctypes.addressof(info)),
        "repro_decode_plan")
    plan = dict(zip(("split", "share", "warps", "smem", "stages"), info))
    _check_smem(plan["smem"])
    return plan


def launch_shape(bh: int, g: int, m: int, d: int, block: int, *,
                 k_keep: int = 0, lop: bool = True, stages: int = 0) -> dict:
    """CTAs, warps per CTA, dynamic shared-memory bytes, CTAs a lane
    (``split``, one cluster), blocks a CTA (``share``) and the ring's depth
    (``stages``) of one call over ``bh`` lanes of G = ``g`` query rows,
    capacity ``m``, head dim ``d`` at ring depth ``stages`` (0: the
    default); and what the card holds of that launch at once
    (``resident_clusters``, ``ctas_per_sm``), which the plan never depends
    on."""
    args = (g, m // block, d, block, k_keep if lop else 0, lop)
    plan = _plan(*args, stages)
    occ = (ctypes.c_int * 2)()
    _build.check(_build.load("decode_attention").repro_decode_occupancy(
        *args[:5], int(lop), stages, ctypes.addressof(occ)),
        "repro_decode_occupancy")
    return dict(ctas=bh * plan["split"], warps=plan["warps"],
                smem=plan["smem"], split=plan["split"], share=plan["share"],
                stages=plan["stages"], resident_clusters=occ[0],
                ctas_per_sm=occ[1])


def fused_decode_attention(qi, qsc, k_cache, v_cache, k_scale, v_scale, feat,
                           new_len, *, hkv: int, block: int, k_keep: int,
                           window: int, softmax_scale: float,
                           shared_select: bool = False, pos_offset: int = 0,
                           return_stats: bool = False, stages: int = 0):
    """LOP mode. qi int8 [BH, G, d], qsc f32 [BH, G], k/v int8 [BH, M, d],
    k/v scales f32 [BH, M], feat uint8 [BH, M, d/2], new_len int32 [B] →
    f32 [BH, G, d] (with ``return_stats`` also m, ℓ f32 [BH, G]); a
    lane's output depends on that lane's inputs alone."""
    lib = _build.load("decode_attention")
    bh, g, m, d = _check_common(qi, qsc, k_cache, v_cache, k_scale, v_scale,
                                new_len, hkv=hkv, block=block)
    if k_keep < 1:
        raise ValueError(f"k_keep={k_keep} must be ≥ 1")
    require(feat, "feat", torch.uint8, (bh, m, d // 2))
    _check_aligned(feat=feat)
    po = _check_offset(pos_offset, block)
    _plan(g, m // block, d, block, k_keep, True, stages)
    outs, ptrs = _outputs(bh, g, d, qi.device, return_stats)
    if bh:
        rc = lib.repro_lop_decode_attention(
            qi.data_ptr(), qsc.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
            feat.data_ptr(), new_len.data_ptr(), *ptrs, bh, g, m, d, hkv,
            block, k_keep, int(window), po, int(bool(shared_select)), stages,
            float(softmax_scale), _stream(qi))
        _build.check(rc, "repro_lop_decode_attention")
        fused_decode_attention.launches += 1
    return outs if return_stats else outs[0]


fused_decode_attention.launches = 0
fused_decode_attention.modes = {}


def fused_dense_decode_attention(qi, qsc, k_cache, v_cache, k_scale, v_scale,
                                 new_len, *, hkv: int, block: int,
                                 window: int, softmax_scale: float,
                                 pos_offset: int = 0,
                                 return_stats: bool = False, stages: int = 0):
    """Dense mode. qi int8 [BH, G, d], qsc f32 [BH, G], k/v int8
    [BH, M, d], k/v scales f32 [BH, M], new_len int32 [B] → f32
    [BH, G, d] (with ``return_stats`` also m, ℓ f32 [BH, G]); a lane's
    output depends on that lane's inputs alone."""
    lib = _build.load("decode_attention")
    bh, g, m, d = _check_common(qi, qsc, k_cache, v_cache, k_scale, v_scale,
                                new_len, hkv=hkv, block=block)
    po = _check_offset(pos_offset, block)
    _plan(g, m // block, d, block, 0, False, stages)
    outs, ptrs = _outputs(bh, g, d, qi.device, return_stats)
    if bh:
        rc = lib.repro_dense_decode_attention(
            qi.data_ptr(), qsc.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
            new_len.data_ptr(), *ptrs, bh, g, m, d, hkv, block, int(window),
            po, stages, float(softmax_scale), _stream(qi))
        _build.check(rc, "repro_dense_decode_attention")
        fused_dense_decode_attention.launches += 1
    return outs if return_stats else outs[0]


fused_dense_decode_attention.launches = 0
fused_dense_decode_attention.modes = {}
