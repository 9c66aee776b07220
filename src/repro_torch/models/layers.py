"""Building blocks outside the kernels: norms, rotary, embedding, head,
and the dense FFN dispatch. Parameters are plain dicts of tensors."""

from __future__ import annotations

import torch

from repro_torch.core.qlinear import ffn_node_apply, is_fused_ffn
from repro_torch.core.quantization import rmsnorm


def linear_init(gen: torch.Generator, d_in: int, d_out: int, *, device,
                lead: tuple = ()) -> dict:
    w = torch.randn((*lead, d_in, d_out), generator=gen, device=device,
                    dtype=torch.float32) * (d_in ** -0.5)
    return {"w": w}


def norm_apply(params, x: torch.Tensor, kind: str = "rmsnorm",
               eps: float = 1e-6) -> torch.Tensor:
    if kind != "rmsnorm":
        raise NotImplementedError(f"norm {kind!r} is not ported yet")
    return rmsnorm(x, params["g"], eps)


def embedding_apply(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]


def head_apply(params, x: torch.Tensor) -> torch.Tensor:
    """LM head in f32 ([..., d] @ [d, V]); a plain matmul outside any
    kernel (the serving engine turns TF32 off, so the card runs it in
    full f32)."""
    return x @ params["w"]


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


def ffn_apply(cfg, p, x: torch.Tensor) -> torch.Tensor:
    """Dense FFN in serving format: the whole FFN as one dispatch."""
    if not is_fused_ffn(p):
        raise NotImplementedError("only the fused serving FFN is ported")
    return ffn_node_apply(p, x, gated=cfg.gated_ffn,
                          act="silu" if cfg.gated_ffn else "gelu")
