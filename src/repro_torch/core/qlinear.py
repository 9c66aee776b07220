"""Serving-format linears: one fused dispatch per projection group.

A packed node is ``{"packed": uint8 [k//4, n], "scale": f32 [1, 1] or
[1, n]}`` (a per-column γ row when several projections share one packed
weight, as the fused QKV does); a whole-FFN node carries
``gu_packed``/``gu_scale``/``down_packed``/``down_scale``. Every packed
apply goes through :mod:`repro_torch.kernels.ops`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops


def is_fused_ffn(node) -> bool:
    return isinstance(node, dict) and "gu_packed" in node


def qlinear(node, x: torch.Tensor) -> torch.Tensor:
    """Packed node, x f32 [..., k] → f32 [..., n] — one fused dispatch."""
    return ops.qlinear_fused(x, node["packed"], node["scale"], node.get("b"))


def qlinear_split(node, x: torch.Tensor, widths) -> tuple:
    """Fused multi-projection node → per-projection outputs (views)."""
    y = qlinear(node, x)
    if sum(widths) != y.shape[-1]:
        raise ValueError(f"segment widths {widths} do not cover {y.shape[-1]}")
    return tuple(torch.split(y, list(widths), dim=-1))


def ffn_node_apply(node, x: torch.Tensor, *, gated: bool,
                   act: str) -> torch.Tensor:
    """Whole-FFN serving node → act(x·Wg)·(x·Wu) → barrier → ·Wd."""
    return ops.ffn_fused(x, node["gu_packed"], node["gu_scale"],
                         node["down_packed"], node["down_scale"],
                         gated=gated, act=act)
