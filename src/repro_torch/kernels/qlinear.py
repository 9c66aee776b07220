"""CUDA TINT projection and whole-FFN wrappers (``csrc/qlinear.cu``, on the
ternary tile core ``csrc/ternary_tile.cuh``).

``fused_qlinear`` replaces the Pallas ``fused_qlinear``: absmax barrier →
packed-ternary × int8 GEMM → ``(acc·x_scale)·γ`` → bias → act.
``fused_ffn`` replaces the Pallas ``fused_ffn``: barrier → gate‖up GEMM
writing ``h = act(x·Wg)·(x·Wu)`` as f32 → the barrier of ``h`` → the
down GEMM. The TPU kept ``h`` in VMEM across a sequential grid, which
Hopper's unordered CTAs cannot share; the absmax max is exact, so the
hidden barrier stays the same function. Each call issues its launches
(two for the projection, four for the FFN) from one C entry. The
barrier pass quantizes rows of any k into scratch, so k and f may be any
multiple of 4. Both take the E = 1 form only.

Each wrapper checks its operands, allocates its output and one scratch
buffer with ``torch.empty``, launches on the current stream, raises on a
CUDA error, and counts its calls that launched in ``<fn>.launches``.
"""

from __future__ import annotations

import ctypes

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


def _check_k(k: int) -> None:
    if k <= 0 or k % 4:
        raise ValueError(f"k={k} must be a positive multiple of 4")


def _pad16(k: int) -> int:
    return -(-k // 16) * 16


def _scratch(device, sizes):
    """One ``torch.empty`` byte buffer holding parts of ``sizes`` bytes,
    each 16-byte aligned. → (the buffer, which the caller keeps until its
    launches are enqueued, and each part's address)."""
    offsets, total = [], 0
    for size in sizes:
        offsets.append(total)
        total += _pad16(size)
    buf = torch.empty(max(total, 16), dtype=torch.uint8, device=device)
    return buf, [buf.data_ptr() + o for o in offsets]


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
    _check_k(k)
    require(packed, "packed", torch.uint8)
    if packed.dim() != 2 or packed.shape[0] * 4 != k:
        raise ValueError(f"packed: expected [{k // 4}, n], got "
                         f"{tuple(packed.shape)}")
    n = packed.shape[1]
    require(gamma, "gamma", torch.float32, (n,))
    if bias is not None:
        require(bias, "bias", torch.float32, (n,))
    act_code = _act_code(act)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m and n:
        scratch, (xq, xs) = _scratch(x.device, (m * _pad16(k), 4 * m))
        rc = lib.repro_qlinear(x.data_ptr(), packed.data_ptr(),
                               gamma.data_ptr(),
                               None if bias is None else bias.data_ptr(),
                               out.data_ptr(), xq, xs, m, k, n, act_code,
                               _stream(x))
        _build.check(rc, "repro_qlinear")
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
    _check_k(k)
    require(down_packed, "down_packed", torch.uint8)
    if down_packed.dim() != 2:
        raise ValueError("down_packed: expected [f//4, d_out]")
    f = down_packed.shape[0] * 4
    _check_k(f)
    d_out = down_packed.shape[1]
    gu_width = 2 * f if gated else f
    require(gu_packed, "gu_packed", torch.uint8, (k // 4, gu_width))
    require(gu_scale, "gu_scale", torch.float32, (gu_width,))
    require(down_scale, "down_scale", torch.float32, (d_out,))
    act_code = _act_code(act)
    out = torch.empty((m, d_out), dtype=torch.float32, device=x.device)
    if not (m and d_out):
        return out
    scratch, (xq, xs, h, hq, hs) = _scratch(
        x.device, (m * _pad16(k), 4 * m, 4 * m * f, m * _pad16(f), 4 * m))
    rc = lib.repro_ffn(x.data_ptr(), gu_packed.data_ptr(), gu_scale.data_ptr(),
                       down_packed.data_ptr(), down_scale.data_ptr(),
                       out.data_ptr(), xq, xs, h, hq, hs, m, k, f, d_out,
                       int(gated), act_code, _stream(x))
    _build.check(rc, "repro_ffn")
    fused_ffn.launches += 1
    return out


fused_ffn.launches = 0


def launch_shape(m: int, k: int, n: int, *, gated: bool = False) -> dict:
    """CTAs, warps per CTA, dynamic shared-memory bytes, output tiles and
    the CTAs each tile's k is split over (``split``) of the GEMM launch of
    :func:`fused_qlinear` at x [m, k] × [k//4, n] (``gated``: of
    :func:`fused_ffn`'s gate‖up stage at hidden width n) on the current
    card."""
    info = (ctypes.c_int * 5)()
    _build.check(_build.load("qlinear").repro_qlinear_shape(
        m, k, n, int(gated), ctypes.addressof(info)), "repro_qlinear_shape")
    return dict(zip(("ctas", "warps", "smem", "tiles", "split"), info))
