"""Public kernel entry points of the port — the counterparts of the
reference's ``kernels/ops.py``, with its public shapes and reshapes.

Dispatch is by the device of the tensors: a CPU tensor goes to the plain
PyTorch version in :mod:`repro_torch.kernels.ref`; a CUDA tensor goes to
the hand-written CUDA kernel, or the call raises. Nothing sends a CUDA
tensor to the plain version.

Every kernel counts the calls that launched it (``KERNELS[name].launches``);
:func:`reset_launch_counts` and :func:`launch_counts` read them around a run,
and :func:`add_launches` adds the launches a CUDA graph's replay makes,
which no wrapper sees.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.lop import pot
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.decode_attention import (
    fused_decode_attention, fused_dense_decode_attention)
from repro_torch.kernels.int8_attention import (int8_flash_prefill,
                                                sparse_decode_attention)
from repro_torch.kernels.lop_scores import lop_scores_kernel
from repro_torch.kernels.prefill_attention import fused_prefill_attention
from repro_torch.kernels.qlinear import fused_ffn, fused_qlinear
from repro_torch.kernels.ternary_matmul import (
    ternary_matmul as ternary_matmul_kernel)

KERNELS = {
    "fused_qlinear": fused_qlinear,
    "fused_ffn": fused_ffn,
    "fused_prefill_attention": fused_prefill_attention,
    "fused_decode_attention": fused_decode_attention,
    "fused_dense_decode_attention": fused_dense_decode_attention,
    "ternary_matmul": ternary_matmul_kernel,
    "lop_scores_kernel": lop_scores_kernel,
    "int8_flash_prefill": int8_flash_prefill,
    "sparse_decode_attention": sparse_decode_attention,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def add_launches(counts: dict[str, int]) -> None:
    """Add ``counts`` (kernel name → launches, negative to take back the
    calls a graph capture counted but did not launch) to the counts."""
    for name, n in counts.items():
        KERNELS[name].launches += n


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def _col_scale(scale: torch.Tensor, n: int) -> torch.Tensor:
    """Per-node γ (scalar or per-column row) → per-column f32 row [.., 1, n]."""
    return scale.to(torch.float32).expand(*scale.shape[:-2], 1, n)


def _lanes(t: torch.Tensor, lead: tuple, name: str) -> int:
    """Check that ``t`` starts with the lane dims ``lead``; → their count."""
    if tuple(t.shape[:len(lead)]) != tuple(lead):
        raise ValueError(f"{name}: leading dims {tuple(t.shape)} do not "
                         f"start with the lane dims {tuple(lead)}")
    return math.prod(lead)


def ternary_matmul(x, tw):
    """int8 activations [..., k] × a packed TernaryWeight → the raw int32
    accumulator [..., n]; the caller dequantizes (``(acc·x_scale)·γ``)."""
    k, n = tw.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    if not _on_cuda(x):
        out = _ref.ternary_matmul_ref(x2, tw.packed, k)
    else:
        out = ternary_matmul_kernel(x2.contiguous(), tw.packed.contiguous())
    return out.reshape(*lead, n)


def lop_screen(q, feat_packed):
    """LOP surrogate scores: int8 queries [..., d] × packed (sgn‖LO) cache
    [m, d//2] → int32 [..., m], with pot() applied to q here.

    Batched as a vmap of that call is: with ``feat_packed`` [*L, m, d//2]
    and q [*L, ..., d], lane l's queries are screened against lane l's
    cache, all lanes in one launch → [*L, ..., m].
    """
    d = q.shape[-1]
    lead = feat_packed.shape[:-2]
    m = feat_packed.shape[-2]
    n_lanes = _lanes(q, lead, "q")
    rows = q.shape[len(lead):-1]
    qp = pot(q).reshape(n_lanes, -1, d)
    feat = feat_packed.reshape(n_lanes, m, feat_packed.shape[-1])
    if not _on_cuda(q):
        out = _ref.lop_scores_ref(qp, feat)
    else:
        out = lop_scores_kernel(qp.contiguous(), feat.contiguous())
    return out.reshape(*lead, *rows, m)


def flash_prefill(q, k, v, q_scale, k_scale, v_scale, *,
                  softmax_scale: float, causal: bool = True, window: int = 0):
    """One head of int8 flash attention: q/k/v int8 [s, d], per-token
    scales f32 [s, 1] → f32 [s, d]; causal, sliding-window (``window``)
    or non-causal."""
    fn = int8_flash_prefill if _on_cuda(q) else _ref.flash_prefill_ref
    return fn(*(t.contiguous() for t in (q, k, v, q_scale, k_scale,
                                          v_scale)),
              softmax_scale=softmax_scale, causal=causal, window=window)


def sparse_decode(q, k_cache, v_cache, q_scale, k_scale, v_scale, block_idx,
                  gate_tokens, *, block: int, softmax_scale: float):
    """Decode attention over caller-chosen K/V blocks of one kv head.

    q int8 [g, d]; k/v_cache int8 [m, d]; q_scale f32 [g, 1]; k/v_scale
    f32 [m, 1]; block_idx int32 [nb], walked in order; gate_tokens int32
    [3·nb] = [gate ‖ end ‖ start]: tokens [start, end) of a gated block are
    live. → f32 [g, d]; a call whose gates are all 0 gives exact zero.

    Batched as a vmap of that call is: block_idx [*L, nb], gate_tokens
    [*L, 3·nb], q [*L, g, d], q_scale [*L, g, 1], and caches [*C, m, d]
    with scales [*C, m, 1], C a prefix of L — lanes past C share their
    cache lane, as the Fig. 8 path broadcasts a kv head's cache over its
    query heads (L = (B, Hkv, G), C = (B, Hkv)). One launch runs every
    lane → f32 [*L, g, d].
    """
    lead = block_idx.shape[:-1]
    cache_lead = k_cache.shape[:-2]
    nb = block_idx.shape[-1]
    g, d = q.shape[-2:]
    m = k_cache.shape[-2]
    n_lanes = _lanes(q, lead, "q")
    if tuple(lead[:len(cache_lead)]) != tuple(cache_lead):
        raise ValueError(f"cache lanes {tuple(cache_lead)} are not a prefix "
                         f"of the lanes {tuple(lead)}")
    n_cache = math.prod(cache_lead)
    args = (q.reshape(n_lanes, g, d), k_cache.reshape(n_cache, m, d),
            v_cache.reshape(n_cache, m, d), q_scale.reshape(n_lanes, g, 1),
            k_scale.reshape(n_cache, m, 1), v_scale.reshape(n_cache, m, 1),
            block_idx.reshape(n_lanes, nb).to(torch.int32),
            gate_tokens.reshape(n_lanes, 3 * nb).to(torch.int32))
    fn = (sparse_decode_attention if _on_cuda(q)
          else _ref.sparse_decode_attention_ref)
    out = fn(*(a.contiguous() for a in args), block=block,
             softmax_scale=softmax_scale)
    return out.reshape(*lead, g, d)


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
