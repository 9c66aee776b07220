"""Public kernel entry points of the port — the counterparts of the
reference's ``kernels/ops.py``, with its public shapes and reshapes.

Dispatch is by the device of the tensors: a CPU tensor goes to the plain
PyTorch version in :mod:`repro_torch.kernels.ref`; a CUDA tensor goes to
the hand-written CUDA kernel, or the call raises. Nothing sends a CUDA
tensor to the plain version.

Every kernel counts the calls that launched it (``KERNELS[name].launches``);
:func:`reset_launch_counts` and :func:`launch_counts` read them around a run.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.decode_attention import (
    fused_decode_attention, fused_dense_decode_attention)
from repro_torch.kernels.prefill_attention import fused_prefill_attention
from repro_torch.kernels.qlinear import fused_ffn, fused_qlinear

KERNELS = {
    "fused_qlinear": fused_qlinear,
    "fused_ffn": fused_ffn,
    "fused_prefill_attention": fused_prefill_attention,
    "fused_decode_attention": fused_decode_attention,
    "fused_dense_decode_attention": fused_dense_decode_attention,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def _col_scale(scale: torch.Tensor, n: int) -> torch.Tensor:
    """Per-node γ (scalar or per-column row) → per-column f32 row [.., 1, n]."""
    return scale.to(torch.float32).expand(*scale.shape[:-2], 1, n)


def qlinear_fused(x, packed, scale, bias=None, *, act=None):
    """f32 activations [..., k] × packed ternary [k//4, n] → f32 [..., n].

    The absmax barrier, the packed-ternary GEMM and the dequant/bias/act
    epilogue as one dispatch. A 3-D ``packed`` [E, k//4, n] with x
    [E, C, k] is the grouped-expert form (plain version only so far).
    """
    k = packed.shape[-2] * 4
    n = packed.shape[-1]
    scale_row = _col_scale(scale, n)
    if not _on_cuda(x):
        return _ref.qlinear_ref(x, packed, scale_row, bias, act=act)
    if packed.dim() != 2:
        raise NotImplementedError("the CUDA projection takes E = 1 only")
    x2 = x.reshape(-1, k).to(torch.float32).contiguous()
    out = fused_qlinear(x2, packed.contiguous(),
                        scale_row.reshape(n).contiguous(),
                        None if bias is None else
                        bias.reshape(n).to(torch.float32).contiguous(),
                        act=act)
    return out.reshape(*x.shape[:-1], n)


def ffn_fused(x, gu_packed, gu_scale, down_packed, down_scale, *,
              gated: bool, act: str):
    """The whole FFN — act(x·Wg)·(x·Wu) → absmax barrier → ·Wd.
    x [..., d]; gu_packed [d//4, 2f] (gate ‖ up; [d//4, f] ungated);
    down_packed [f//4, d_out]. → f32 [..., d_out]."""
    k = gu_packed.shape[-2] * 4
    d_out = down_packed.shape[-1]
    gu_row = _col_scale(gu_scale, gu_packed.shape[-1])
    down_row = _col_scale(down_scale, d_out)
    if not _on_cuda(x):
        return _ref.ffn_fused_ref(x, gu_packed, gu_row, down_packed,
                                  down_row, gated=gated, act=act)
    if gu_packed.dim() != 2:
        raise NotImplementedError("the CUDA FFN takes E = 1 only")
    x2 = x.reshape(-1, k).to(torch.float32).contiguous()
    out = fused_ffn(x2, gu_packed.contiguous(),
                    gu_row.reshape(-1).contiguous(), down_packed.contiguous(),
                    down_row.reshape(-1).contiguous(), gated=gated, act=act)
    return out.reshape(*x.shape[:-1], d_out)


def prefill_attention(qi, qsc, k_cache, v_cache, k_scale, v_scale, kv_len, *,
                      q_offset=None, causal: bool = True, window: int = 0,
                      softmax_scale: float | None = None,
                      int8_logits: bool = False):
    """Whole-prompt and chunked prefill attention.

    qi int8 [B, H, C, dh]; qsc f32 [B, H, C]; k/v_cache int8 [B, Hkv, M,
    dh]; k/v_scale f32 [B, Hkv, M]; kv_len int32 [B]; ``q_offset`` the
    global position of query column 0. → f32 [B, H, C, dh].
    """
    b, h, c, dh = qi.shape
    hkv, m = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    if h != g * hkv:
        raise ValueError(f"H={h} is not a multiple of Hkv={hkv}")
    if softmax_scale is None:
        softmax_scale = dh ** -0.5
    kv_len = kv_len.to(torch.int32)
    q_off = 0 if q_offset is None else int(q_offset)
    if not _on_cuda(qi):
        return _ref.prefill_attention_ref(
            qi, qsc, k_cache, v_cache, k_scale, v_scale, kv_len, q_off,
            causal=causal, window=window, softmax_scale=softmax_scale,
            int8_logits=int8_logits)
    # flatten (B, Hkv) → the kernel's lane axis; rows g-major (g·C + t)
    bh = b * hkv
    out = fused_prefill_attention(
        qi.reshape(bh, g * c, dh).contiguous(),
        qsc.reshape(bh, g * c).to(torch.float32).contiguous(),
        k_cache.reshape(bh, m, dh).contiguous(),
        v_cache.reshape(bh, m, dh).contiguous(),
        k_scale.reshape(bh, m).contiguous(),
        v_scale.reshape(bh, m).contiguous(), kv_len.contiguous(), q_off,
        hkv=hkv, chunk=c, causal=causal, window=window,
        softmax_scale=softmax_scale)
    return out.reshape(b, h, c, dh)


def decode_attention(qi, qsc, k_cache, v_cache, k_scale, v_scale, feat,
                     new_len, *, block: int, k_keep: int, window: int = 0,
                     softmax_scale: float | None = None, use_lop: bool = True,
                     shared_select: bool = False, pos_offset=None,
                     return_stats: bool = False):
    """LOP screen → comparison-free block top-K → exact attention (or the
    dense baseline with ``use_lop=False``).

    qi int8 [B, H, dh]; qsc f32 [B, H, 1]; k/v_cache int8 [B, Hkv, M, dh];
    k/v_scale f32 [B, Hkv, M]; feat uint8 [B, Hkv, M, dh//2]; new_len
    int32 [B] (0 = retired lane, emits exact zero). → f32 [B, H, dh]
    (or ``(out, m, ℓ)`` with ``return_stats``).
    """
    b, h, dh = qi.shape
    hkv, m = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    if h != g * hkv or m % block:
        raise ValueError(f"H={h}, Hkv={hkv}, M={m}, block={block}")
    if softmax_scale is None:
        softmax_scale = dh ** -0.5
    new_len = new_len.to(torch.int32)
    if not _on_cuda(qi):
        return _ref.decode_attention_ref(
            qi, qsc, k_cache, v_cache, k_scale, v_scale, feat, new_len,
            block=block, k_keep=k_keep, window=window,
            softmax_scale=softmax_scale, use_lop=use_lop,
            shared_select=shared_select, pos_offset=pos_offset,
            return_stats=return_stats)
    bh = b * hkv
    lanes = (qi.reshape(bh, g, dh).contiguous(),
             qsc.reshape(bh, g).to(torch.float32).contiguous(),
             k_cache.reshape(bh, m, dh).contiguous(),
             v_cache.reshape(bh, m, dh).contiguous(),
             k_scale.reshape(bh, m).contiguous(),
             v_scale.reshape(bh, m).contiguous())
    po = 0 if pos_offset is None else int(pos_offset)
    if use_lop:
        out = fused_decode_attention(
            *lanes, feat.reshape(bh, m, dh // 2).contiguous(),
            new_len.contiguous(), hkv=hkv, block=block, k_keep=k_keep,
            window=window, softmax_scale=softmax_scale,
            shared_select=shared_select, pos_offset=po,
            return_stats=return_stats)
    else:
        # the dense body never reads the selection, so shared_select is
        # moot there (as in the reference kernel)
        out = fused_dense_decode_attention(
            *lanes, new_len.contiguous(), hkv=hkv, block=block,
            window=window, softmax_scale=softmax_scale, pos_offset=po,
            return_stats=return_stats)
    return out.reshape(b, h, dh)
