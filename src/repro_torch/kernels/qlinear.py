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
multiple of 4. ``fused_qlinear_experts`` and ``fused_ffn_experts`` are
the TPU kernels' leading expert axis: x [E, C, k] against expert stacks,
the expert a grid coordinate of the same launches (no loop over
experts); each form counts its own launches.

Each wrapper checks its operands, allocates its output and one scratch
buffer with ``torch.empty``, launches on the current stream, raises on a
CUDA error, and counts its calls that launched in ``<fn>.launches`` (a
projection's with a bias also under ``<fn>.modes["bias"]``, an ungated
FFN's under ``["ungated"]``).

The tile sweep's knobs (:mod:`repro_torch.kernels.autotune`) reach the
GEMMs as ``split`` (CTAs a tile's k is split over, 1–8) and ``tile`` (rows
a tile, 16 or 128); 0 is the planner's choice, and every setting gives
the same bits (exact int32 sums, the same epilogue an element).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

ACT_CODES = {None: 0, "silu": 1, "gelu": 2, "squared_relu": 3}


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


def _qlinear(x, packed, gamma, bias, act, counter, split: int = 0,
             tile: int = 0) -> torch.Tensor:
    """One launch of ``repro_qlinear`` over x [E, m, k] × packed [E, k//4,
    n], gamma [E, n], bias [E, n] or None → f32 [E, m, n]; a launch adds
    one to ``counter.launches``."""
    lib = _build.load("qlinear")
    require(x, "x", torch.float32)
    e, m, k = x.shape
    _check_k(k)
    require(packed, "packed", torch.uint8)
    if packed.dim() != 3 or packed.shape[:2] != (e, k // 4):
        raise ValueError(f"packed: expected [{e}, {k // 4}, n], got "
                         f"{tuple(packed.shape)}")
    n = packed.shape[2]
    require(gamma, "gamma", torch.float32, (e, n))
    if bias is not None:
        require(bias, "bias", torch.float32, (e, n))
    act_code = _act_code(act)
    out = torch.empty((e, m, n), dtype=torch.float32, device=x.device)
    if e and m and n:
        scratch, (xq, xs) = _scratch(x.device, (e * m * _pad16(k), 4 * e * m))
        rc = lib.repro_qlinear(x.data_ptr(), packed.data_ptr(),
                               gamma.data_ptr(),
                               None if bias is None else bias.data_ptr(),
                               out.data_ptr(), xq, xs, e, m, k, n, act_code,
                               split, tile, _stream(x))
        _build.check(rc, "repro_qlinear")
        counter.launches += 1
        if bias is not None:
            _build.count_mode(counter, "bias")
    return out


def fused_qlinear(x: torch.Tensor, packed: torch.Tensor, gamma: torch.Tensor,
                  bias: torch.Tensor | None = None, *,
                  act: str | None = None, split: int = 0,
                  tile: int = 0) -> torch.Tensor:
    """f32 x [m, k] × packed ternary [k//4, n] → f32 [m, n].

    ``gamma`` f32 [n] is the per-column γ row; ``bias`` f32 [n] or None.
    """
    if x.dim() != 2 or packed.dim() != 2:
        raise ValueError(f"x, packed: expected [m, k] and [k//4, n], got "
                         f"{tuple(x.shape)} and {tuple(packed.shape)}")
    return _qlinear(x[None], packed[None], gamma[None],
                    None if bias is None else bias[None], act,
                    fused_qlinear, split, tile)[0]


def fused_qlinear_experts(x: torch.Tensor, packed: torch.Tensor,
                          gamma: torch.Tensor,
                          bias: torch.Tensor | None = None, *,
                          act: str | None = None, split: int = 0,
                          tile: int = 0) -> torch.Tensor:
    """The grouped-expert projection: f32 x [E, C, k] × packed ternary
    [E, k//4, n] → f32 [E, C, n], expert e's rows against expert e's
    weights, every expert in one launch. ``gamma`` f32 [E, n]; ``bias``
    f32 [E, n] or None."""
    if x.dim() != 3:
        raise ValueError(f"x: expected [E, C, k], got {tuple(x.shape)}")
    return _qlinear(x, packed, gamma, bias, act, fused_qlinear_experts,
                    split, tile)


def _ffn(x, gu_packed, gu_scale, down_packed, down_scale, gated, act,
         counter, split_gu: int = 0, split_down: int = 0,
         tile: int = 0) -> torch.Tensor:
    """One launch of ``repro_ffn`` over x [E, m, k] → f32 [E, m, d_out]; a
    launch adds one to ``counter.launches``."""
    lib = _build.load("qlinear")
    require(x, "x", torch.float32)
    e, m, k = x.shape
    _check_k(k)
    require(down_packed, "down_packed", torch.uint8)
    if down_packed.dim() != 3 or down_packed.shape[0] != e:
        raise ValueError(f"down_packed: expected [{e}, f//4, d_out], got "
                         f"{tuple(down_packed.shape)}")
    f = down_packed.shape[1] * 4
    _check_k(f)
    d_out = down_packed.shape[2]
    gu_width = 2 * f if gated else f
    require(gu_packed, "gu_packed", torch.uint8, (e, k // 4, gu_width))
    require(gu_scale, "gu_scale", torch.float32, (e, gu_width))
    require(down_scale, "down_scale", torch.float32, (e, d_out))
    act_code = _act_code(act)
    out = torch.empty((e, m, d_out), dtype=torch.float32, device=x.device)
    if not (e and m and d_out):
        return out
    rows = e * m
    scratch, (xq, xs, h, hq, hs) = _scratch(
        x.device, (rows * _pad16(k), 4 * rows, 4 * rows * f,
                   rows * _pad16(f), 4 * rows))
    rc = lib.repro_ffn(x.data_ptr(), gu_packed.data_ptr(), gu_scale.data_ptr(),
                       down_packed.data_ptr(), down_scale.data_ptr(),
                       out.data_ptr(), xq, xs, h, hq, hs, e, m, k, f, d_out,
                       int(gated), act_code, split_gu, split_down, tile,
                       _stream(x))
    _build.check(rc, "repro_ffn")
    counter.launches += 1
    if not gated:
        _build.count_mode(counter, "ungated")
    return out


def fused_ffn(x: torch.Tensor, gu_packed: torch.Tensor, gu_scale: torch.Tensor,
              down_packed: torch.Tensor, down_scale: torch.Tensor, *,
              gated: bool, act: str, split_gu: int = 0, split_down: int = 0,
              tile: int = 0) -> torch.Tensor:
    """f32 x [m, k] → f32 [m, d_out] through the whole FFN.

    gu_packed uint8 [k//4, 2f] (gate ‖ up; [k//4, f] ungated), gu_scale
    f32 [2f] (or [f]); down_packed uint8 [f//4, d_out], down_scale f32
    [d_out].
    """
    if x.dim() != 2 or gu_packed.dim() != 2 or down_packed.dim() != 2:
        raise ValueError("fused_ffn: expected x [m, k] and 2-D weights")
    return _ffn(x[None], gu_packed[None], gu_scale[None], down_packed[None],
                down_scale[None], gated, act, fused_ffn, split_gu, split_down,
                tile)[0]


def fused_ffn_experts(x: torch.Tensor, gu_packed: torch.Tensor,
                      gu_scale: torch.Tensor, down_packed: torch.Tensor,
                      down_scale: torch.Tensor, *, gated: bool, act: str,
                      split_gu: int = 0, split_down: int = 0,
                      tile: int = 0) -> torch.Tensor:
    """The grouped-expert FFN: f32 x [E, C, k] → f32 [E, C, d_out], expert
    e's rows through expert e's gate‖up [E, k//4, 2f] (γ [E, 2f]) and down
    [E, f//4, d_out] (γ [E, d_out]) streams, every expert in the same four
    launches of one C entry."""
    if x.dim() != 3:
        raise ValueError(f"x: expected [E, C, k], got {tuple(x.shape)}")
    return _ffn(x, gu_packed, gu_scale, down_packed, down_scale, gated, act,
                fused_ffn_experts, split_gu, split_down, tile)


for _fn in (fused_qlinear, fused_qlinear_experts, fused_ffn,
            fused_ffn_experts):
    _fn.launches = 0
    _fn.modes = {}
del _fn


def launch_shape(m: int, k: int, n: int, *, gated: bool = False,
                 experts: int = 1, split: int = 0, tile: int = 0) -> dict:
    """CTAs, warps per CTA, dynamic shared-memory bytes, output tiles, the
    CTAs each tile's k is split over (``split``) and the rows a tile
    (``tile``) of the GEMM launch of :func:`fused_qlinear` at x [m, k] ×
    [k//4, n] (``gated``: of :func:`fused_ffn`'s gate‖up stage at hidden
    width n; ``experts``: of the grouped-expert form with m rows an
    expert) on the current card, at the knobs ``split`` and ``tile`` (0:
    the planner's choice)."""
    info = (ctypes.c_int * 6)()
    _build.check(_build.load("qlinear").repro_qlinear_shape(
        experts, m, k, n, int(gated), split, tile, ctypes.addressof(info)),
        "repro_qlinear_shape")
    return dict(zip(("ctas", "warps", "smem", "tiles", "split", "tile"),
                    info))
