"""Building blocks outside the kernels: norms, rotary, embedding, head,
the linear and dense FFN dispatches. Parameters are plain dicts of
tensors. Every function here is differentiable on f32 master nodes (the
training forward); on packed serving nodes it calls the kernels."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.qlinear import (ffn_node_apply, is_fused_ffn,
                                      is_packed, qlinear)
from repro_torch.core.quantization import rmsnorm
from repro_torch.core.ternary import bitlinear_qat


def linear_init(gen: torch.Generator, d_in: int, d_out: int, *, device,
                lead: tuple = (), bias: bool = False) -> dict:
    """``{"w"}`` drawn from ``gen`` with fan-in scaling; ``bias=True`` adds
    a zero ``b`` [d_out], as the reference's ``linear_init`` does."""
    w = torch.randn((*lead, d_in, d_out), generator=gen, device=device,
                    dtype=torch.float32) * (d_in ** -0.5)
    out = {"w": w}
    if bias:
        out["b"] = torch.zeros((*lead, d_out), dtype=torch.float32,
                               device=device)
    return out


def linear_apply(params, x: torch.Tensor, *, quant: str) -> torch.Tensor:
    """One linear by its node's format, as the reference's
    ``linear_apply``: a packed node is #1 (barrier, packed-ternary GEMM,
    dequant and bias in one launch); an f32 node ``{"w", "b"?}`` (a
    training master) is the QAT BitLinear
    (:func:`~repro_torch.core.ternary.bitlinear_qat`) under
    ``quant="ternary"`` or a plain matmul otherwise, then its bias."""
    if is_packed(params):
        return qlinear(params, x)
    if quant == "ternary":
        y = bitlinear_qat(x, params["w"])
    else:
        y = x @ params["w"].to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def serving_linear(params, x: torch.Tensor, *, quant: str) -> torch.Tensor:
    """``linear_apply`` as the serving mixers call it: an f32 ternary node
    (a projection too small to pack, such as reduced jamba's ``dt_proj``,
    k 8) takes ``bitlinear_qat``'s batch-invariant product."""
    if is_packed(params) or quant != "ternary":
        return linear_apply(params, x, quant=quant)
    y = bitlinear_qat(x, params["w"], batch_invariant=True)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def mixer_linear(train: bool):
    """The recurrent mixers' projection: ``linear_apply`` (the QAT
    product with f32 accumulation) in the training forward,
    ``serving_linear`` when serving."""
    return linear_apply if train else serving_linear


def norm_init(d: int, kind: str, *, device) -> dict:
    """``{"g"}`` ones for RMSNorm; ``{"g", "b"}`` (ones, zeros) for
    LayerNorm."""
    out = {"g": torch.ones(d, dtype=torch.float32, device=device)}
    if kind != "rmsnorm":
        out["b"] = torch.zeros(d, dtype=torch.float32, device=device)
    return out


def _row_mean(x: torch.Tensor) -> torch.Tensor:
    """f32 mean over the last axis as the reference forms it, the sum
    times the f32 reciprocal of the count; the sum is taken in float64
    and rounded once, so a row's value does not depend on the other rows
    (see ``rmsnorm``)."""
    s = x.to(torch.float64).sum(dim=-1, keepdim=True).to(torch.float32)
    return s * (1.0 / x.shape[-1])


def norm_apply(params, x: torch.Tensor, kind: str = "rmsnorm",
               eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm, or LayerNorm with the population variance (``jnp.var``'s,
    not ``torch.var``'s default unbiased one): ``(x − μ)·rsqrt(var +
    eps)·g + b`` in f32, cast back to x's dtype. The rsqrt is rounded
    once from float64, the same on the CPU and the card."""
    if kind == "rmsnorm":
        return rmsnorm(x, params["g"], eps)
    xf = x.to(torch.float32)
    centered = xf - _row_mean(xf)
    var = _row_mean(centered * centered)
    inv = torch.rsqrt((var + eps).to(torch.float64)).to(torch.float32)
    return (centered * inv * params["g"] + params["b"]).to(x.dtype)


def embedding_apply(params, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the f32 table; its gradient is a scatter-add over the
    tokens (the reference's ``jnp.take``), summed in another order."""
    return F.embedding(tokens, params["table"])


def head_apply(params, x: torch.Tensor) -> torch.Tensor:
    """LM head in f32 ([..., d] @ [d, V]), x promoted to f32 as the
    reference's bf16 @ f32 is; a plain matmul outside any kernel (the
    serving engine turns TF32 off, so the card runs it in full f32)."""
    return x.to(params["w"].dtype) @ params["w"]


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split rotary embedding. x [..., S, H, dh]; positions [..., S]."""
    dh = x.shape[-1]
    half = dh // 2
    idx = torch.arange(0, half, dtype=torch.float32, device=x.device)
    # divide by a tensor (true division on every device) and take the base
    # as a Python float, so no host-to-device copy is needed
    freqs = torch.pow(float(theta), -(idx / torch.full_like(idx, half)))
    ang = positions[..., None].to(torch.float32) * freqs      # [..., S, half]
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """The reference's silu: x·sigmoid(x)."""
    return x * torch.sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh form."""
    return F.gelu(x, approximate="tanh")


def ffn_apply(cfg, p, x: torch.Tensor) -> torch.Tensor:
    """Dense FFN by its node's format, as the reference's ``ffn_apply``:
    the fused serving node is one dispatch of #2; the training masters
    ``{"w_gate"?, "w_up", "w_down"}`` are QAT BitLinears, silu(gate)·up
    (or gelu(up) ungated), then down."""
    act = "silu" if cfg.gated_ffn else "gelu"
    if is_fused_ffn(p):
        return ffn_node_apply(p, x, gated=cfg.gated_ffn, act=act)
    if cfg.gated_ffn:
        h = silu(linear_apply(p["w_gate"], x, quant=cfg.quant))
        h = h * linear_apply(p["w_up"], x, quant=cfg.quant)
    else:
        h = gelu(linear_apply(p["w_up"], x, quant=cfg.quant))
    return linear_apply(p["w_down"], h, quant=cfg.quant)
