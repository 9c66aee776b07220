"""CUDA LOP screen wrapper (``csrc/lop_scores.cu``).

Replaces the Pallas ``lop_scores_kernel``: pot-rounded int8 queries ×
the packed (sgn‖LO) feature cache → int32 surrogate scores, exactly. A
leading lane axis takes the place of a vmap over (batch, kv-head): one
launch screens every lane.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import _check_smem
from repro_torch.kernels.qlinear import _stream, require


@functools.lru_cache(maxsize=None)
def _plan(g: int, d: int) -> dict:
    """The launch plan of one shape (checked once)."""
    info = (ctypes.c_int * 3)()
    _build.check(_build.load("lop_scores").repro_lop_scores_plan(
        g, d, ctypes.addressof(info)), "repro_lop_scores_plan")
    plan = dict(zip(("tokens", "warps", "smem"), info))
    _check_smem(plan["smem"])
    return plan


def launch_shape(lanes: int, g: int, m: int, d: int) -> dict:
    """CTAs (``tiles`` of ``tokens`` tokens a lane), warps per CTA and
    dynamic shared-memory bytes of one :func:`lop_scores_kernel` call."""
    plan = _plan(g, d)
    tiles = -(-m // plan["tokens"])
    return dict(plan, tiles=tiles, ctas=lanes * tiles)


def lop_scores_kernel(q_pot: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
    """q_pot int8 [L, g, d] × feat uint8 [L, m, d//2] → int32 [L, g, m]."""
    lib = _build.load("lop_scores")
    require(q_pot, "q_pot", torch.int8)
    if q_pot.dim() != 3:
        raise ValueError(f"q_pot: expected [L, g, d], got "
                         f"{tuple(q_pot.shape)}")
    lanes, g, d = q_pot.shape
    if d % 4:
        raise ValueError(f"d={d} must be a multiple of 4")
    if lanes > 65535:
        raise ValueError(f"{lanes} lanes exceed the grid's 65535")
    require(feat, "feat", torch.uint8)
    if feat.dim() != 3 or feat.shape[0] != lanes or feat.shape[2] * 2 != d:
        raise ValueError(f"feat: expected [{lanes}, m, {d // 2}], got "
                         f"{tuple(feat.shape)}")
    m = feat.shape[1]
    _plan(g, d)
    out = torch.empty((lanes, g, m), dtype=torch.int32, device=q_pot.device)
    if lanes and g and m:
        rc = lib.repro_lop_scores(q_pot.data_ptr(), feat.data_ptr(),
                                  out.data_ptr(), lanes, g, m, d,
                                  _stream(q_pot))
        _build.check(rc, "repro_lop_scores")
        lop_scores_kernel.launches += 1
    return out


lop_scores_kernel.launches = 0
lop_scores_kernel.modes = {}
