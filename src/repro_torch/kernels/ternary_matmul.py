"""CUDA TINT GEMM wrapper (``csrc/ternary_matmul.cu``).

Replaces the Pallas ``ternary_matmul``: int8 activations × packed 2-bit
ternary weights → the raw int32 accumulator, no barrier and no
dequantization. Exact, so bitwise the plain version; k may be any
multiple of 4.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.qlinear import _stream, require


def ternary_matmul(x: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """int8 x [m, k] × packed uint8 [k//4, n] → int32 [m, n]."""
    lib = _build.load("ternary_matmul")
    require(x, "x", torch.int8)
    if x.dim() != 2:
        raise ValueError(f"x: expected [m, k], got {tuple(x.shape)}")
    m, k = x.shape
    max_k = lib.repro_ternary_matmul_max_k()
    if k % 4 or k > max_k:
        raise ValueError(f"k={k} must be a multiple of 4 and at most {max_k}")
    require(packed, "packed", torch.uint8)
    if packed.dim() != 2 or packed.shape[0] * 4 != k:
        raise ValueError(f"packed: expected [{k // 4}, n], got "
                         f"{tuple(packed.shape)}")
    n = packed.shape[1]
    out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    if m and n:
        rc = lib.repro_ternary_matmul(x.data_ptr(), packed.data_ptr(),
                                      out.data_ptr(), m, k, n, _stream(x))
        _build.check(rc, "repro_ternary_matmul")
        ternary_matmul.launches += 1
    return out


ternary_matmul.launches = 0
