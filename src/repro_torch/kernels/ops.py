"""Public kernel entry points of the port — the counterparts of the
reference's ``kernels/ops.py``, with its public shapes and reshapes.

Dispatch is by the device of the tensors: a CPU tensor goes to the plain
PyTorch version in :mod:`repro_torch.kernels.ref`; a CUDA tensor goes to
the hand-written CUDA kernel, or the call raises. Nothing sends a CUDA
tensor to the plain version.

Every kernel counts the calls that launched it (``KERNELS[name].launches``)
and, under a mode's name, those that launched it in that mode
(``KERNELS[name].modes``: #1 with a bias, #2 ungated, #3 non-causal, and
#4/#5 over an encdec model's cross pages, which :func:`decode_attention`
counts for a call given ``mode="cross"``); :func:`reset_launch_counts` and
:func:`launch_counts` read them around a run, and :func:`add_launches`
adds the launches a CUDA graph's replay makes, which no wrapper sees.

The entries of the five kernels the reference tunes feed the tile
autotuner (:mod:`repro_torch.kernels.autotune`), as the reference's do:
each dispatch's shape goes to ``observe`` (a no-op unless a shape log is
armed), and on a CUDA tensor ``lookup`` names the launch's knobs — ``{}``
with no table and no override, the kernels' own plan. Neither syncs.

A meta tensor runs through an entry only under an active
:class:`repro_torch.analysis.op_trace.OpTrace` (the dry-run's trace of
one rank's program): the entry computes nothing, makes ``torch.empty``
outputs of the kernel's shapes and dtypes on ``meta`` and records one
launch of the kernel (under its mode, the keys of
:func:`launch_counts`) with its :func:`repro_torch.analysis.roofline.
kernel_cost`. With no trace a meta tensor raises, as any device but the
CPU and CUDA does; the meta branch is no fallback.
"""

from __future__ import annotations

import math

import torch

from repro_torch.analysis import op_trace as _trace
from repro_torch.analysis.roofline import kernel_cost
from repro_torch.core.lop import pot
from repro_torch.kernels import _build
from repro_torch.kernels import autotune as _tune
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.decode_attention import (
    fused_decode_attention, fused_dense_decode_attention)
from repro_torch.kernels.int8_attention import (int8_flash_prefill,
                                                sparse_decode_attention)
from repro_torch.kernels.lop_scores import lop_scores_kernel
from repro_torch.kernels.prefill_attention import fused_prefill_attention
from repro_torch.kernels.qlinear import (fused_ffn, fused_ffn_experts,
                                         fused_qlinear, fused_qlinear_experts)
from repro_torch.kernels.ternary_matmul import (
    ternary_matmul as ternary_matmul_kernel)

KERNELS = {
    "fused_qlinear": fused_qlinear,
    "fused_ffn": fused_ffn,
    "fused_qlinear_experts": fused_qlinear_experts,
    "fused_ffn_experts": fused_ffn_experts,
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
        fn.modes = {}


def launch_counts(modes: bool = False) -> dict[str, int]:
    """Kernel name → launches; with ``modes`` also ``"name:mode"`` →
    the launches in that mode."""
    out = {name: fn.launches for name, fn in KERNELS.items()}
    if modes:
        out.update({f"{name}:{mode}": n for name, fn in KERNELS.items()
                    for mode, n in fn.modes.items()})
    return out


def add_launches(counts: dict[str, int]) -> None:
    """Add ``counts`` (kernel name, or ``"name:mode"`` → launches; negative
    to take back the calls a graph capture counted but did not launch) to
    the counts."""
    for name, n in counts.items():
        kernel, _, mode = name.partition(":")
        fn = KERNELS[kernel]
        if mode:
            fn.modes[mode] = fn.modes.get(mode, 0) + n
        else:
            fn.launches += n


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def _traced(t: torch.Tensor) -> bool:
    """Whether ``t`` is a meta tensor under an active trace (the entry
    then records the launch); any other meta tensor raises."""
    if t.device.type != "meta":
        return False
    if _trace.current() is None:
        raise ValueError("unsupported device meta: a meta tensor runs "
                         "through a kernel entry only under an OpTrace")
    return True


def _record(kernel: str, mode, cost: dict, *outputs):
    """One traced launch of ``kernel``: ``outputs`` ((shape, dtype) each)
    made on meta, the launch recorded with its cost — unless the first
    output is empty, which the kernel's wrapper launches nothing for.
    → the outputs."""
    tr = _trace.current()
    with tr.paused():
        made = [torch.empty(shape, dtype=dtype, device="meta")
                for shape, dtype in outputs]
    if made[0].numel():
        tr.kernel(kernel, mode, cost)
    return made[0] if len(made) == 1 else made


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
    dims = {"m": x2.shape[0], "k": k, "n": n}
    _tune.observe("ternary_matmul", dims)
    if _traced(x):
        return _record("ternary_matmul", None,
                       kernel_cost("ternary_matmul", **dims),
                       ((*lead, n), torch.int32))
    if not _on_cuda(x):
        out = _ref.ternary_matmul_ref(x2, tw.packed, k)
    else:
        tuned = _tune.lookup("ternary_matmul", dims)
        out = ternary_matmul_kernel(x2.contiguous(), tw.packed.contiguous(),
                                    split=tuned.get("split", 0),
                                    tile=tuned.get("tile", 0))
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
    if _traced(q):
        return _record("lop_scores_kernel", None, kernel_cost(
            "lop_scores_kernel", lanes=n_lanes, r=math.prod(rows), m=m,
            d=d), ((*lead, *rows, m), torch.int32))
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
    if _traced(q):
        s, d = q.shape
        return _record("int8_flash_prefill", None, kernel_cost(
            "int8_flash_prefill", s=s, d=d, causal=causal, window=window),
            ((s, d), torch.float32))
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
    if _traced(q):
        # a meta trace has no gates to read: every listed block is live
        return _record("sparse_decode_attention", None, kernel_cost(
            "sparse_decode_attention", lanes=n_lanes, g=g, d=d, nb=nb,
            live=n_lanes * nb * block), ((*lead, g, d), torch.float32))
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
    [E, C, k] (scale [E, 1, n] or [E, 1, 1], bias [E, 1, n]) is the
    grouped-expert form: every expert in the same launch.
    """
    k = packed.shape[-2] * 4
    n = packed.shape[-1]
    expert = packed.dim() == 3
    dims = {"e": x.shape[0] if expert else 1,
            "m": x.shape[1] if expert else math.prod(x.shape[:-1]),
            "k": k, "n": n}
    _tune.observe("qlinear", dims)
    if _traced(x):
        name = "fused_qlinear_experts" if expert else "fused_qlinear"
        return _record(name, None if bias is None else "bias", kernel_cost(
            name, **dims, bias=bias is not None),
            ((*x.shape[:-1], n), torch.float32))
    scale_row = _col_scale(scale, n)
    if not _on_cuda(x):
        return _ref.qlinear_ref(x, packed, scale_row, bias, act=act)
    tuned = _tune.lookup("qlinear", dims)
    knobs = dict(split=tuned.get("split", 0), tile=tuned.get("tile", 0))
    if expert:
        e = packed.shape[0]
        if x.dim() != 3 or x.shape[0] != e:
            raise ValueError(f"x {tuple(x.shape)} is not [E={e}, C, k]")
        return fused_qlinear_experts(
            x.to(torch.float32).contiguous(), packed.contiguous(),
            scale_row.reshape(e, n).contiguous(),
            None if bias is None else
            bias.to(torch.float32).expand(e, 1, n).reshape(e, n).contiguous(),
            act=act, **knobs)
    x2 = x.reshape(-1, k).to(torch.float32).contiguous()
    out = fused_qlinear(x2, packed.contiguous(),
                        scale_row.reshape(n).contiguous(),
                        None if bias is None else
                        bias.reshape(n).to(torch.float32).contiguous(),
                        act=act, **knobs)
    return out.reshape(*x.shape[:-1], n)


def ffn_fused(x, gu_packed, gu_scale, down_packed, down_scale, *,
              gated: bool, act: str):
    """The whole FFN — act(x·Wg)·(x·Wu) → absmax barrier → ·Wd.
    x [..., d]; gu_packed [d//4, 2f] (gate ‖ up; [d//4, f] ungated);
    down_packed [f//4, d_out]. → f32 [..., d_out]. Expert stacks
    (gu_packed [E, d//4, 2f], gu_scale [E, 1, 2f], down_packed [E, f//4,
    d_out], down_scale [E, 1, 1]) with x [E, C, d] run every expert in
    the same launches."""
    k = gu_packed.shape[-2] * 4
    d_out = down_packed.shape[-1]
    expert = gu_packed.dim() == 3
    dims = {"e": x.shape[0] if expert else 1,
            "m": x.shape[1] if expert else math.prod(x.shape[:-1]),
            "k": k, "f": down_packed.shape[-2] * 4, "n": d_out}
    _tune.observe("ffn", dims)
    if _traced(x):
        name = "fused_ffn_experts" if expert else "fused_ffn"
        return _record(name, None if gated else "ungated", kernel_cost(
            name, **dims, gated=gated), ((*x.shape[:-1], d_out),
                                         torch.float32))
    gu_row = _col_scale(gu_scale, gu_packed.shape[-1])
    down_row = _col_scale(down_scale, d_out)
    if not _on_cuda(x):
        return _ref.ffn_fused_ref(x, gu_packed, gu_row, down_packed,
                                  down_row, gated=gated, act=act)
    tuned = _tune.lookup("ffn", dims)
    knobs = dict(split_gu=tuned.get("split_gu", 0),
                 split_down=tuned.get("split_down", 0),
                 tile=tuned.get("tile", 0))
    if expert:
        e = gu_packed.shape[0]
        if x.dim() != 3 or x.shape[0] != e:
            raise ValueError(f"x {tuple(x.shape)} is not [E={e}, C, d]")
        # γ stays [E, n]: expert e's row is read by expert e's CTAs
        return fused_ffn_experts(
            x.to(torch.float32).contiguous(), gu_packed.contiguous(),
            gu_row.reshape(e, -1).contiguous(), down_packed.contiguous(),
            down_row.reshape(e, -1).contiguous(), gated=gated, act=act,
            **knobs)
    x2 = x.reshape(-1, k).to(torch.float32).contiguous()
    out = fused_ffn(x2, gu_packed.contiguous(),
                    gu_row.reshape(-1).contiguous(), down_packed.contiguous(),
                    down_row.reshape(-1).contiguous(), gated=gated, act=act,
                    **knobs)
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
    # no knob: the tiles are fixed by the fragment layout (autotune's
    # KERNEL_PARAMS["prefill"] is empty); the shape is logged all the same
    _tune.observe("prefill", {"bhg": b * hkv, "r": g * c, "d": dh, "m": m,
                              "chunk": c})
    if _traced(qi):
        if k_cache.shape[0] != b or kv_len.shape[0] != b:
            raise ValueError(f"lanes: qi {b}, cache {k_cache.shape[0]}, "
                             f"kv_len {kv_len.shape[0]}")
        # the keys a causal chunk attends end at its last row; a
        # non-causal call's kv_len is data, so every row of the view
        kvl = min(m, q_off + c) if causal else m
        return _record("fused_prefill_attention",
                       None if causal else "non_causal", kernel_cost(
                           "fused_prefill_attention", b=b, h=h, hkv=hkv,
                           c=c, dh=dh, kvl=kvl, q_off=q_off, causal=causal,
                           window=window), ((b, h, c, dh), torch.float32))
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
                     return_stats: bool = False, mode: str | None = None):
    """LOP screen → comparison-free block top-K → exact attention (or the
    dense baseline with ``use_lop=False``).

    qi int8 [B, H, dh]; qsc f32 [B, H, 1]; k/v_cache int8 [B, Hkv, M, dh];
    k/v_scale f32 [B, Hkv, M]; feat uint8 [B, Hkv, M, dh//2]; new_len
    int32 [B] (0 = retired lane, emits exact zero); ``pos_offset`` the
    global position of cache row 0 (a multiple of ``block``; ``new_len``
    stays global). → f32 [B, H, dh] (or ``(out, m, ℓ)`` with
    ``return_stats``, m and ℓ f32 [B, H, 1] in natural-log units).
    ``mode`` names the call's mode for the launch counts (``"cross"``:
    over cross pages, which no decode step writes).
    """
    b, h, dh = qi.shape
    hkv, m = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    if h != g * hkv or m % block:
        raise ValueError(f"H={h}, Hkv={hkv}, M={m}, block={block}")
    if softmax_scale is None:
        softmax_scale = dh ** -0.5
    new_len = new_len.to(torch.int32)
    dims = {"bhg": b * hkv, "g": g, "d": dh, "m": m, "block": block,
            "k_keep": k_keep}
    _tune.observe("decode", dims)
    if _traced(qi):
        if k_cache.shape[0] != b or new_len.shape[0] != b:
            raise ValueError(f"lanes: qi {b}, cache {k_cache.shape[0]}, "
                             f"new_len {new_len.shape[0]}")
        return _traced_decode(b, h, hkv, dh, m, block, k_keep, use_lop,
                              pos_offset, return_stats, mode)
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
    stages = _tune.lookup("decode", dims).get("stages", 0)
    kernel = fused_decode_attention if use_lop else \
        fused_dense_decode_attention
    before = kernel.launches
    if use_lop:
        out = fused_decode_attention(
            *lanes, feat.reshape(bh, m, dh // 2).contiguous(),
            new_len.contiguous(), hkv=hkv, block=block, k_keep=k_keep,
            window=window, softmax_scale=softmax_scale,
            shared_select=shared_select, pos_offset=po,
            return_stats=return_stats, stages=stages)
    else:
        # the dense body never reads the selection, so shared_select is
        # moot there (as in the reference kernel)
        out = fused_dense_decode_attention(
            *lanes, new_len.contiguous(), hkv=hkv, block=block,
            window=window, softmax_scale=softmax_scale, pos_offset=po,
            return_stats=return_stats, stages=stages)
    if mode is not None and kernel.launches > before:
        _build.count_mode(kernel, mode)
    if return_stats:
        out, mx, l = out
        return (out.reshape(b, h, dh), mx.reshape(b, h, 1),
                l.reshape(b, h, 1))
    return out.reshape(b, h, dh)


def _traced_decode(b, h, hkv, dh, m, block, k_keep, use_lop, pos_offset,
                   return_stats, mode):
    """A decode launch under a trace. ``new_len`` is data: each lane holds
    the trace's ``seq_len`` tokens (global; this call's rows past
    ``pos_offset``), or every row of the capacity without one and over
    cross pages."""
    seq = _trace.current().seq_len
    if seq is None or mode == "cross":
        rows = m
    else:
        rows = max(0, min(m, seq - (pos_offset or 0)))
    name = "fused_decode_attention" if use_lop else \
        "fused_dense_decode_attention"
    cost = kernel_cost(name, b=b, h=h, hkv=hkv, dh=dh, block=block,
                       k_keep=k_keep, new_len=[rows] * b,
                       return_stats=return_stats)
    outs = [((b, h, dh), torch.float32)]
    if return_stats:
        outs += [((b, h, 1), torch.float32)] * 2
    return _record(name, mode, cost, *outs)
