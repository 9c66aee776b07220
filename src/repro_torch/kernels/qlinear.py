"""CUDA TINT projection and whole-FFN wrappers (``csrc/qlinear.cu``).

``fused_qlinear`` replaces the Pallas ``fused_qlinear``: absmax barrier →
packed-ternary × int8 GEMM → ``(acc·x_scale)·γ`` → bias → act, in one
launch. ``fused_ffn`` replaces the Pallas ``fused_ffn`` in two launches:
the gate/up stage writes ``h = act(x·Wg)·(x·Wu)`` as f32 into device
memory, then the projection kernel runs on ``h`` with the down weights —
the TPU kept ``h`` in VMEM across a sequential grid, which Hopper's
unordered CTAs cannot share, and the absmax max is exact, so the hidden
barrier stays the same function. Both take the E = 1 form only.

Each wrapper checks its operands, allocates its output with
``torch.empty``, launches on the current stream, raises on a CUDA error,
and counts its calls that launched in ``<fn>.launches``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

ACT_CODES = {None: 0, "silu": 1, "gelu": 2}


def require(t: torch.Tensor, name: str, dtype, shape=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype``/``shape``."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 4:
        raise ValueError(f"{name}: data must be 4-byte aligned")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _act_code(act) -> int:
    if act not in ACT_CODES:
        raise ValueError(f"unknown activation {act!r}")
    return ACT_CODES[act]


def _check_k(lib, k: int) -> None:
    if k % 4 or k > lib.repro_qlinear_max_k():
        raise ValueError(f"k={k} must be a multiple of 4 and at most "
                         f"{lib.repro_qlinear_max_k()}")


def _project(lib, x, packed, gamma, bias, act) -> torch.Tensor:
    m, k = x.shape
    n = packed.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m:
        rc = lib.repro_qlinear(x.data_ptr(), packed.data_ptr(),
                               gamma.data_ptr(),
                               None if bias is None else bias.data_ptr(),
                               out.data_ptr(), m, k, n, _act_code(act),
                               _stream(x))
        _build.check(rc, "repro_qlinear")
    return out


def fused_qlinear(x: torch.Tensor, packed: torch.Tensor, gamma: torch.Tensor,
                  bias: torch.Tensor | None = None, *,
                  act: str | None = None) -> torch.Tensor:
    """f32 x [m, k] × packed ternary [k//4, n] → f32 [m, n].

    ``gamma`` f32 [n] is the per-column γ row; ``bias`` f32 [n] or None.
    """
    lib = _build.load("qlinear")
    require(x, "x", torch.float32)
    if x.dim() != 2:
        raise ValueError(f"x: expected [m, k], got {tuple(x.shape)}")
    m, k = x.shape
    _check_k(lib, k)
    require(packed, "packed", torch.uint8)
    if packed.dim() != 2 or packed.shape[0] * 4 != k:
        raise ValueError(f"packed: expected [{k // 4}, n], got "
                         f"{tuple(packed.shape)}")
    n = packed.shape[1]
    require(gamma, "gamma", torch.float32, (n,))
    if bias is not None:
        require(bias, "bias", torch.float32, (n,))
    out = _project(lib, x, packed, gamma, bias, act)
    if m:                                  # _project launched the kernel
        fused_qlinear.launches += 1
    return out


fused_qlinear.launches = 0


def fused_ffn(x: torch.Tensor, gu_packed: torch.Tensor, gu_scale: torch.Tensor,
              down_packed: torch.Tensor, down_scale: torch.Tensor, *,
              gated: bool, act: str) -> torch.Tensor:
    """f32 x [m, k] → f32 [m, d_out] through the whole FFN.

    gu_packed uint8 [k//4, 2f] (gate ‖ up; [k//4, f] ungated), gu_scale
    f32 [2f] (or [f]); down_packed uint8 [f//4, d_out], down_scale f32
    [d_out].
    """
    lib = _build.load("qlinear")
    require(x, "x", torch.float32)
    if x.dim() != 2:
        raise ValueError(f"x: expected [m, k], got {tuple(x.shape)}")
    m, k = x.shape
    _check_k(lib, k)
    require(down_packed, "down_packed", torch.uint8)
    if down_packed.dim() != 2:
        raise ValueError("down_packed: expected [f//4, d_out]")
    f = down_packed.shape[0] * 4
    _check_k(lib, f)
    d_out = down_packed.shape[1]
    gu_width = 2 * f if gated else f
    require(gu_packed, "gu_packed", torch.uint8, (k // 4, gu_width))
    require(gu_scale, "gu_scale", torch.float32, (gu_width,))
    require(down_scale, "down_scale", torch.float32, (d_out,))
    if not m:
        return torch.empty((0, d_out), dtype=torch.float32, device=x.device)
    if gated:
        h = torch.empty((m, f), dtype=torch.float32, device=x.device)
        rc = lib.repro_ffn_gate_up(x.data_ptr(), gu_packed.data_ptr(),
                                   gu_scale.data_ptr(), h.data_ptr(), m, k, f,
                                   _act_code(act), _stream(x))
        _build.check(rc, "repro_ffn_gate_up")
    else:
        h = _project(lib, x, gu_packed, gu_scale, None, act)
    out = _project(lib, h, down_packed, down_scale, None, None)
    fused_ffn.launches += 1
    return out


fused_ffn.launches = 0
