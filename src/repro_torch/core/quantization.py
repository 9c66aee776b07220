"""Absmax quantization barrier (paper §III-C).

Every cross-core interface is an ``(int8 vector, one f32 scale)`` pair:
the per-vector absmax doubles as the barrier between the producing linear
stream and its consumer. Reductions stay in f32. The op order is the
reference's: ``scale = max(amax, EPS) / 127`` and ``q = clip(round(x /
scale))`` with round-half-to-even and a true f32 division, so the int8
values are bitwise the reference's for equal inputs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

INT8_MAX = 127.0
EPS = 1e-5


class QuantizedTensor(NamedTuple):
    values: torch.Tensor   # int8 [..., d]
    scale: torch.Tensor    # f32  [..., 1]


def absmax_scale(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Per-vector absmax reduction α = max|x| / 127 (the barrier)."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(EPS).to(
        torch.float32)
    # divide by a tensor, not a Python scalar: on CUDA, PyTorch turns
    # ``t / scalar`` into ``t * (1 / scalar)``, which is not the IEEE quotient
    return amax / torch.full_like(amax, INT8_MAX)


def quantize(x: torch.Tensor, dim: int = -1) -> QuantizedTensor:
    """Quantize once per vector after the absmax reduction completes."""
    scale = absmax_scale(x, dim=dim)
    q = torch.round(x.to(torch.float32) / scale).clamp(-INT8_MAX, INT8_MAX)
    return QuantizedTensor(values=q.to(torch.int8), scale=scale)


def dequantize(qt: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    return (qt.values.to(torch.float32) * qt.scale).to(dtype)


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer product of small-int tensors → int32.

    Formed as a float64 matmul of the int values, which is exact far
    beyond these magnitudes (CUDA has no integer matmul, and an int8
    matmul on the CPU wraps), then cast to int32.
    """
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(
        torch.int32)


def int8_matmul(xq: QuantizedTensor, wq_values: torch.Tensor,
                w_scale: torch.Tensor) -> torch.Tensor:
    """Integer-domain GEMM with one output dequantization.

    ``xq.values [..., k] @ wq_values [k, n]`` accumulated exactly in int32,
    then ``(acc·x_scale)·w_scale`` in f32 — the reference's op order.
    """
    acc = int_matmul(xq.values, wq_values)
    return acc.to(torch.float32) * xq.scale * w_scale


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    # mean of squares summed in float64 and rounded once to f32: a row's
    # value does not depend on how the reduction is laid out over the
    # other rows, so chunked and whole-prompt prefill agree bitwise
    ms = xf.to(torch.float64).square().mean(dim=-1, keepdim=True).to(
        torch.float32)
    y = xf * torch.rsqrt(ms + eps)
    return (y * gamma.to(torch.float32)).to(x.dtype)


def online_softmax_stats(logits: torch.Tensor, dim: int = -1):
    """Running max and sum of exponentials (the softmax reductions)."""
    m = logits.amax(dim=dim, keepdim=True)
    s = torch.exp(logits - m).sum(dim=dim, keepdim=True)
    return m, s
