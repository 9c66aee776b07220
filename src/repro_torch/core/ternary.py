"""Ternary weights (BitNet b1.58) and their packed 2-bit code stream.

Weights live in device memory as 2-bit codes, four per byte, packed along
the reduction axis: code j of byte ``[i, n]`` holds k-row ``4*i + j``.
Code 1 is +1, code 2 is −1, codes 0 and 3 are 0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.quantization import (QuantizedTensor, int8_matmul,
                                           quantize, ste_quantize)

EPS = 1e-5

_CODE_ZERO, _CODE_POS, _CODE_NEG = 0, 1, 2


class TernaryWeight(NamedTuple):
    """A ternary weight in packed form: 2-bit codes, four per byte, packed
    along the reduction (first) axis."""

    packed: torch.Tensor   # uint8 [k//4, n]
    scale: torch.Tensor    # f32 γ: [1, 1], or [1, n] per output channel
    shape: tuple           # the unpacked (k, n)


def ternary_quantize(w: torch.Tensor, per_channel: bool = False):
    """Absmean quantization: γ = mean|W|, Wt = clip(round(W/γ), −1, 1).

    Returns (Wt int8, γ f32). γ is a mean over the matrix, so its last bit
    depends on the summation order; the tests convert the reference's
    quantized tree instead of requantizing.
    """
    w = w.to(torch.float32)
    if per_channel:
        gamma = w.abs().mean(dim=0, keepdim=True)
    else:
        gamma = w.abs().mean()
    gamma = gamma.clamp_min(EPS)
    wt = torch.round(w / gamma).clamp(-1, 1).to(torch.int8)
    return wt, gamma.to(torch.float32)


def ste_ternary(w: torch.Tensor, per_channel: bool = False) -> torch.Tensor:
    """The QAT forward value of a weight, dequantized ternary, formed as
    the reference forms it: ``w + (Wt·γ − w)``, with the difference
    detached, so the gradient is the identity onto the f32 master (none
    flows through γ)."""
    wt, gamma = ternary_quantize(w, per_channel=per_channel)
    wq = (wt.to(torch.float32) * gamma).to(w.dtype)
    return w + (wq - w).detach()


def pack_ternary(wt: torch.Tensor) -> torch.Tensor:
    """int8 ternary [k, n] → uint8 codes [k//4, n]."""
    k, n = wt.shape
    if k % 4:
        raise ValueError(f"k={k} must be a multiple of 4 (pad before packing)")
    codes = torch.where(wt > 0, _CODE_POS, torch.where(wt < 0, _CODE_NEG,
                                                        _CODE_ZERO))
    codes = codes.to(torch.uint8).reshape(k // 4, 4, n)
    return (codes[:, 0] | (codes[:, 1] << 2) | (codes[:, 2] << 4)
            | (codes[:, 3] << 6))


def unpack_ternary(packed: torch.Tensor, k: int) -> torch.Tensor:
    """uint8 codes [..., k//4, n] → int8 ternary [..., k, n]."""
    *lead, kp, n = packed.shape
    if kp * 4 != k:
        raise ValueError(f"packed rows {kp} do not cover k={k}")
    parts = [(packed >> (2 * j)) & 0x3 for j in range(4)]
    codes = torch.stack(parts, dim=-2).reshape(*lead, k, n)
    return ((codes == _CODE_POS).to(torch.int8)
            - (codes == _CODE_NEG).to(torch.int8))


def make_ternary_weight(w: torch.Tensor,
                        per_channel: bool = False) -> TernaryWeight:
    wt, gamma = ternary_quantize(w, per_channel=per_channel)
    return TernaryWeight(packed=pack_ternary(wt),
                         scale=gamma.reshape(1, -1) if per_channel
                         else gamma.reshape(1, 1),
                         shape=tuple(w.shape))


def bitlinear_infer(xq: QuantizedTensor, tw: TernaryWeight) -> torch.Tensor:
    """int8 activations × ternary weights, one dequantization at the end:
    ``(acc·x_scale)·γ`` with the integer GEMM exact."""
    wt = unpack_ternary(tw.packed, tw.shape[0])
    return int8_matmul(xq, wt, tw.scale)


def bitlinear_qat(x: torch.Tensor, w: torch.Tensor,
                  per_channel: bool = False, *,
                  batch_invariant: bool = False) -> torch.Tensor:
    """The QAT BitLinear: the absmax-quantized activations (per row) times
    the dequantized ternary weights, both through the straight-through
    estimator, so the gradient reaches x and the f32 master w as a plain
    product's would.

    Two callers, two products. Training (``batch_invariant=False``, the
    default: ``forward_train`` through ``linear_apply``) takes the
    reference's: operands in x's dtype, f32 accumulation (a product of
    two bf16 or f32 values summed in f32), rounded to x's dtype. Serving
    (``batch_invariant=True``, through ``layers.serving_linear``: the
    recurrent mixers of ``models/rwkv6.py`` and ``models/mamba.py``, whose
    projections too small to pack — k not a
    multiple of 4, or below 16, such as reduced jamba's ``dt_proj`` — stay
    f32 nodes) takes it in float64, rounded once, so a row's value does
    not depend on how many rows share the call."""
    xq = ste_quantize(x)
    wq = ste_ternary(w, per_channel=per_channel).to(x.dtype)
    if batch_invariant:
        return torch.matmul(xq.to(torch.float64),
                            wq.to(torch.float64)).to(x.dtype)
    return torch.matmul(xq, wq)


def bitlinear_ref(x: torch.Tensor, tw: TernaryWeight) -> torch.Tensor:
    """f32 in → absmax barrier → integer GEMM → f32."""
    return bitlinear_infer(quantize(x), tw)


def memory_footprint_bytes(shape: tuple, fmt: str) -> int:
    """Weight storage of a [k, n] matrix in ``bf16``, ``int8`` or
    ``ternary_packed`` form (2 bits a weight plus one f32 scale)."""
    k, n = shape
    return {
        "bf16": 2 * k * n,
        "int8": k * n,
        "ternary_packed": (k // 4) * n + 4,
    }[fmt]
