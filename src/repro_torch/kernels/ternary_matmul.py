"""CUDA TINT GEMM wrapper (``csrc/ternary_matmul.cu``, on the ternary tile
core ``csrc/ternary_tile.cuh``).

Replaces the Pallas ``ternary_matmul``: int8 activations × packed 2-bit
ternary weights → the raw int32 accumulator, no barrier and no
dequantization. Exact, so bitwise the plain version; k may be any
multiple of 4. Where a tile's k is split over a cluster of CTAs, they
sum their partial tiles through distributed shared memory (exact integer
sums, so the same bits every call).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.qlinear import _stream, require


def ternary_matmul(x: torch.Tensor, packed: torch.Tensor, *, split: int = 0,
                   tile: int = 0) -> torch.Tensor:
    """int8 x [m, k] × packed uint8 [k//4, n] → int32 [m, n]. ``split``
    (CTAs a tile's k is split over, 1–8) and ``tile`` (rows a tile, 16 or
    128) are the tile sweep's knobs, 0 the planner's choice: the same bits
    at every setting."""
    lib = _build.load("ternary_matmul")
    require(x, "x", torch.int8)
    if x.dim() != 2:
        raise ValueError(f"x: expected [m, k], got {tuple(x.shape)}")
    m, k = x.shape
    if k % 4:
        raise ValueError(f"k={k} must be a multiple of 4")
    require(packed, "packed", torch.uint8)
    if packed.dim() != 2 or packed.shape[0] * 4 != k:
        raise ValueError(f"packed: expected [{k // 4}, n], got "
                         f"{tuple(packed.shape)}")
    n = packed.shape[1]
    out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    if m and n:
        rc = lib.repro_ternary_matmul(x.data_ptr(), packed.data_ptr(),
                                      out.data_ptr(), m, k, n, split, tile,
                                      _stream(x))
        _build.check(rc, "repro_ternary_matmul")
        ternary_matmul.launches += 1
    return out


ternary_matmul.launches = 0
ternary_matmul.modes = {}


def launch_shape(m: int, k: int, n: int, *, split: int = 0,
                 tile: int = 0) -> dict:
    """CTAs, warps per CTA, dynamic shared-memory bytes, output tiles, the
    CTAs each tile's k is split over (``split``) and the rows a tile
    (``tile``) of one :func:`ternary_matmul` launch on the current card, at
    the knobs ``split`` and ``tile`` (0: the planner's choice)."""
    info = (ctypes.c_int * 6)()
    _build.check(_build.load("ternary_matmul").repro_ternary_matmul_shape(
        m, k, n, split, tile, ctypes.addressof(info)),
        "repro_ternary_matmul_shape")
    return dict(zip(("ctas", "warps", "smem", "tiles", "split", "tile"),
                    info))
