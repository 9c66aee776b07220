"""CUDA wrappers of the standalone int8 attention kernels
(``csrc/int8_attention.cu``), the two entries of the Pallas
``int8_attention`` module:

* :func:`int8_flash_prefill` — one head of causal, sliding-window or
  non-causal int8 flash attention with per-token scales;
* :func:`sparse_decode_attention` — decode attention over caller-chosen
  K/V blocks with [gate ‖ end ‖ start] live intervals, a leading lane axis
  in place of a vmap over (batch, kv-head, group): one launch runs every
  lane, and ``L // C`` consecutive lanes share one cache lane.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import (MAX_D, _check_aligned,
                                                  _check_smem)
from repro_torch.kernels.qlinear import _stream, require


def int8_flash_prefill(q, k, v, q_scale, k_scale, v_scale, *,
                       softmax_scale: float, causal: bool = True,
                       window: int = 0) -> torch.Tensor:
    """q/k/v int8 [s, d]; q/k/v_scale f32 [s, 1] → f32 [s, d]."""
    lib = _build.load("int8_attention")
    require(q, "q", torch.int8)
    if q.dim() != 2:
        raise ValueError(f"q: expected [s, d], got {tuple(q.shape)}")
    s, d = q.shape
    max_d = lib.repro_flash_prefill_max_d()
    if d % 4 or d > max_d:
        raise ValueError(f"head dim {d} must be a multiple of 4 and at most "
                         f"{max_d}")
    require(k, "k", torch.int8, (s, d))
    require(v, "v", torch.int8, (s, d))
    for name, t in (("q_scale", q_scale), ("k_scale", k_scale),
                    ("v_scale", v_scale)):
        require(t, name, torch.float32, (s, 1))
    out = torch.empty((s, d), dtype=torch.float32, device=q.device)
    if s:
        rc = lib.repro_flash_prefill(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_scale.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), out.data_ptr(), s, d,
            int(bool(causal)), int(window), float(softmax_scale), _stream(q))
        _build.check(rc, "repro_flash_prefill")
        int8_flash_prefill.launches += 1
    return out


int8_flash_prefill.launches = 0


def flash_prefill_launch_shape(s: int, d: int) -> dict:
    """CTAs, warps per CTA and dynamic shared-memory bytes of one
    :func:`int8_flash_prefill` launch over ``s`` tokens at head dim ``d``."""
    lib = _build.load("int8_attention")
    rows = lib.repro_flash_prefill_rows()
    return dict(ctas=-(-s // rows), warps=lib.repro_flash_prefill_warps(),
                smem=lib.repro_flash_prefill_smem_bytes(d))


@functools.lru_cache(maxsize=None)
def _sparse_plan(g: int, nb: int, d: int, block: int) -> dict:
    """The launch plan of one lane shape (checked once)."""
    info = (ctypes.c_int * 4)()
    _build.check(_build.load("int8_attention").repro_sparse_decode_plan(
        g, nb, d, block, ctypes.addressof(info)), "repro_sparse_decode_plan")
    plan = dict(zip(("split", "share", "warps", "smem"), info))
    _check_smem(plan["smem"])
    return plan


def sparse_decode_launch_shape(lanes: int, g: int, d: int, block: int,
                               nb: int) -> dict:
    """CTAs, warps per CTA, dynamic shared-memory bytes, CTAs a lane
    (``split``, one cluster) and list entries a CTA (``share``) of one
    :func:`sparse_decode_attention` call over ``lanes`` lanes of ``g``
    query rows and ``nb`` list entries; and what the card holds of that
    launch at once (``resident_clusters``, ``ctas_per_sm``), which the
    plan never depends on."""
    plan = _sparse_plan(g, nb, d, block)
    occ = (ctypes.c_int * 2)()
    _build.check(_build.load("int8_attention").repro_sparse_decode_occupancy(
        g, nb, d, block, ctypes.addressof(occ)),
        "repro_sparse_decode_occupancy")
    return dict(ctas=lanes * plan["split"], warps=plan["warps"],
                smem=plan["smem"], split=plan["split"], share=plan["share"],
                resident_clusters=occ[0], ctas_per_sm=occ[1])


def sparse_decode_attention(q, k_cache, v_cache, q_scale, k_scale, v_scale,
                            block_idx, gate_tokens, *, block: int,
                            softmax_scale: float) -> torch.Tensor:
    """q int8 [L, g, d]; k/v_cache int8 [C, m, d]; q_scale f32 [L, g, 1];
    k/v_scale f32 [C, m, 1] (L a multiple of C); block_idx int32 [L, nb];
    gate_tokens int32 [L, 3·nb] → f32 [L, g, d]. Each lane runs on a
    cluster of CTAs whose count depends on nb alone
    (:func:`sparse_decode_launch_shape`), so a lane's output is bitwise the
    same whatever the other lanes hold."""
    lib = _build.load("int8_attention")
    require(q, "q", torch.int8)
    if q.dim() != 3:
        raise ValueError(f"q: expected [L, g, d], got {tuple(q.shape)}")
    lanes, g, d = q.shape
    n_cache, m = k_cache.shape[:2]
    if d % 4 or d > MAX_D:
        raise ValueError(f"head dim {d} must be a multiple of 4, ≤ {MAX_D}")
    if block < 8 or block % 8 or m % block:
        raise ValueError(f"m={m} must be a multiple of block={block}, and "
                         f"block a multiple of 8")
    if n_cache < 1 or lanes % n_cache:
        raise ValueError(f"{lanes} lanes are not a multiple of {n_cache} "
                         f"cache lanes")
    if lanes > 65535:
        raise ValueError(f"{lanes} lanes exceed the grid's 65535")
    nb = block_idx.shape[-1]
    require(q_scale, "q_scale", torch.float32, (lanes, g, 1))
    require(k_cache, "k_cache", torch.int8, (n_cache, m, d))
    require(v_cache, "v_cache", torch.int8, (n_cache, m, d))
    require(k_scale, "k_scale", torch.float32, (n_cache, m, 1))
    require(v_scale, "v_scale", torch.float32, (n_cache, m, 1))
    require(block_idx, "block_idx", torch.int32, (lanes, nb))
    require(gate_tokens, "gate_tokens", torch.int32, (lanes, 3 * nb))
    _check_aligned(k_cache=k_cache, v_cache=v_cache, k_scale=k_scale,
                   v_scale=v_scale)
    _sparse_plan(g, nb, d, block)
    out = torch.empty((lanes, g, d), dtype=torch.float32, device=q.device)
    if lanes:
        rc = lib.repro_sparse_decode(
            q.data_ptr(), q_scale.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
            block_idx.data_ptr(), gate_tokens.data_ptr(), out.data_ptr(),
            lanes, g, m, d, nb, lanes // n_cache, block,
            float(softmax_scale), _stream(q))
        _build.check(rc, "repro_sparse_decode")
        sparse_decode_attention.launches += 1
    return out


sparse_decode_attention.launches = 0
