"""Serving engine, dense family: prefill (whole prompt and chunked) and the
one-token decode step.

Per decoder layer the path makes four kernel dispatches through
:mod:`repro_torch.kernels.ops`: the fused QKV projection, prefill or decode
attention, the O projection, and the whole FFN. Everything between them
(RMSNorm, RoPE, the absmax quantization of q/k/v, LOP features, cache
writes, the f32 head) is plain tensor code. Layers are a Python loop over
the layer-stacked weights.

The cache is written in place: prefill writes each layer's K/V/features
into a preallocated capacity-padded cache, a chunk writes its rows at
``[start, start + C)`` of the lane it was given (a view into the pool), and
a decode step appends one token per active lane.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import resolve_decode_flags
from repro_torch.core.lop import lop_features, pack_features
from repro_torch.core.qlinear import qlinear, qlinear_split
from repro_torch.core.quantization import quantize
from repro_torch.kernels import ops
from repro_torch.models.layers import (embedding_apply, ffn_apply, head_apply,
                                       norm_apply, rope)
from repro_torch.models.transformer import layer_slice
from repro_torch.serving.cache import init_cache
from repro_torch.serving.lop_select import k_keep_blocks


def _q(x):
    qt = quantize(x)
    return qt.values, qt.scale


def _check_dense(cfg) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")


def _project_qkv(cfg, lp, h):
    b, s, _ = h.shape
    q, k, v = qlinear_split(lp["wqkv"], h, (cfg.q_dim, cfg.kv_dim,
                                            cfg.kv_dim))
    return (q.reshape(b, s, cfg.n_heads, cfg.hd),
            k.reshape(b, s, cfg.n_kv_heads, cfg.hd),
            v.reshape(b, s, cfg.n_kv_heads, cfg.hd))


def _quantize_kv(k, v):
    """[B, S, Hkv, dh] f32 → int8 K/V, scales and packed features in the
    cache's [B, Hkv, S, ...] layout."""
    ki, ksc = _q(k)
    vi, vsc = _q(v)
    ki = ki.transpose(1, 2)
    vi = vi.transpose(1, 2)
    ksc = ksc[..., 0].transpose(1, 2)
    vsc = vsc[..., 0].transpose(1, 2)
    return ki, vi, ksc, vsc, pack_features(lop_features(ki))


def _write_rows(cl, ki, vi, ksc, vsc, feat, start: int) -> None:
    """Write S quantized tokens at [start, start + S) of a cache layer (in
    place)."""
    s = ki.shape[2]
    cl["k"][:, :, start:start + s] = ki
    cl["v"][:, :, start:start + s] = vi
    cl["k_scale"][:, :, start:start + s] = ksc
    cl["v_scale"][:, :, start:start + s] = vsc
    cl["feat"][:, :, start:start + s] = feat


def _attend_prefill(cfg, lp, h, cl, *, start: int, kv_len):
    """Shared body of whole-prompt and chunked prefill attention."""
    b, s, _ = h.shape
    q, k, v = _project_qkv(cfg, lp, h)
    positions = start + torch.arange(s, device=h.device)[None, :]
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    qi, qsc = _q(q)
    _write_rows(cl, *_quantize_kv(k, v), start)
    o = ops.prefill_attention(
        qi.transpose(1, 2), qsc[..., 0].transpose(1, 2), cl["k"], cl["v"],
        cl["k_scale"], cl["v_scale"], kv_len, q_offset=start, causal=True,
        window=cfg.swa_window, int8_logits=bool(cfg.int8_logits))
    o = o.transpose(1, 2).reshape(b, s, cfg.q_dim)
    return qlinear(lp["wo"], o)


def attn_prefill(cfg, lp, h, cl):
    """Whole-prompt attention; writes K/V/features at [0, S) of ``cl``.

    The prompt is one maximal chunk over the full capacity-padded cache
    (``q_offset`` 0, ``kv_len`` S) — the same op and operand shapes as
    :func:`attn_prefill_chunk`, which is what keeps chunked prefill
    bitwise whole-prompt prefill.
    """
    b, s, _ = h.shape
    kv_len = torch.full((b,), s, dtype=torch.int32, device=h.device)
    return _attend_prefill(cfg, lp, h, cl, start=0, kv_len=kv_len)


def attn_prefill_chunk(cfg, lp, h, cl, *, start: int, kv_len):
    """One C-token chunk at global positions [start, start + C) against a
    cache layer holding every earlier chunk's K/V at [0, start)."""
    return _attend_prefill(cfg, lp, h, cl, start=start, kv_len=kv_len)


def lop_decode_attention(cfg, qi, qsc, cl, new_len, *, window: int,
                         use_lop: bool = True):
    """qi int8 [B, H, dh]; qsc f32 [B, H, 1] → f32 [B, H, dh]."""
    cfg = resolve_decode_flags(cfg)
    m = cl["k"].shape[2]
    k_keep = k_keep_blocks(cfg, m)
    return ops.decode_attention(
        qi, qsc, cl["k"], cl["v"], cl["k_scale"], cl["v_scale"], cl["feat"],
        new_len, block=cfg.lop_block,
        k_keep=max(1, min(k_keep, m // cfg.lop_block)), window=window,
        use_lop=use_lop, shared_select=bool(cfg.gqa_shared_select))


def _write_token(cl, ki, vi, ksc, vsc, feat, lengths, active=None) -> None:
    """Append one token per lane at its own position (in place); lanes
    with ``active`` False keep their bytes (their old row is written back,
    which needs no host sync, unlike selecting the active lanes)."""
    lanes = torch.arange(lengths.shape[0], device=lengths.device)
    pos = lengths.to(torch.int64)
    for key, val in (("k", ki), ("v", vi), ("k_scale", ksc[..., 0]),
                     ("v_scale", vsc[..., 0]), ("feat", feat)):
        if active is not None:
            keep = active.reshape(-1, *([1] * (val.dim() - 1)))
            val = torch.where(keep, val, cl[key][lanes, :, pos])
        cl[key][lanes, :, pos] = val


def attn_decode(cfg, lp, h, cl, lengths, *, use_lop=True, active=None):
    """One-token self-attention with cache append. h [B, 1, D]."""
    b = h.shape[0]
    q, k, v = _project_qkv(cfg, lp, h)
    positions = lengths[:, None]
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    qi, qsc = _q(q[:, 0])                                # [B, H, dh]
    ki, ksc = _q(k[:, 0])                                # [B, Hkv, dh]
    vi, vsc = _q(v[:, 0])
    feat = pack_features(lop_features(ki))
    new_len = lengths + 1
    if active is not None:
        new_len = torch.where(active, new_len, 0)
    _write_token(cl, ki, vi, ksc, vsc, feat, lengths, active)
    out = lop_decode_attention(cfg, qi, qsc, cl, new_len,
                               window=cfg.swa_window,
                               use_lop=use_lop and cfg.use_lop)
    if active is not None:
        out = torch.where(active[:, None, None], out, 0.0)
    return qlinear(lp["wo"], out.reshape(b, 1, cfg.q_dim))


def _mlp(cfg, lp, x):
    return x + ffn_apply(cfg, lp["ffn"], norm_apply(lp["ln2"], x, cfg.norm))


def _logits(cfg, qp, x_last):
    return head_apply(qp["head"], norm_apply(qp["ln_f"], x_last, cfg.norm))


def prefill(cfg, qp, tokens, *, max_len=None):
    """Whole-prompt forward writing a new batch-B cache.

    tokens int [B, S] on the weights' device. → (logits [B, V] at the last
    position, cache with capacity for ``max(max_len, S)`` tokens).
    """
    cfg = resolve_decode_flags(cfg)
    _check_dense(cfg)
    b, s = tokens.shape
    max_len = max(max_len if max_len is not None else 0, s)
    cache = init_cache(cfg, b, max_len, tokens.device)
    x = embedding_apply(qp["embed"], tokens)
    for i in range(cfg.n_layers):
        lp = layer_slice(qp["layers"], i)
        cl = layer_slice(cache["layers"], i)
        x = x + attn_prefill(cfg, lp["attn"],
                             norm_apply(lp["ln1"], x, cfg.norm), cl)
        x = _mlp(cfg, lp, x)
    cache["lengths"].fill_(s)
    return _logits(cfg, qp, x[:, -1]), cache


def prefill_chunk(cfg, qp, tokens, cache, *, start: int, seq_end: int):
    """One chunk of chunked prefill. tokens [B, C] at positions
    [start, start + C); ``cache`` holds [0, start) and is written in place
    at [start, start + C) with ``lengths = seq_end``. → (logits [B, V] at
    position ``seq_end - 1``, cache)."""
    cfg = resolve_decode_flags(cfg)
    _check_dense(cfg)
    b, c = tokens.shape
    kv_len = torch.full((b,), start + c, dtype=torch.int32,
                        device=tokens.device)
    x = embedding_apply(qp["embed"], tokens)
    for i in range(cfg.n_layers):
        lp = layer_slice(qp["layers"], i)
        cl = layer_slice(cache["layers"], i)
        x = x + attn_prefill_chunk(cfg, lp["attn"],
                                   norm_apply(lp["ln1"], x, cfg.norm), cl,
                                   start=start, kv_len=kv_len)
        x = _mlp(cfg, lp, x)
    cache["lengths"].fill_(seq_end)
    idx = min(max(seq_end - 1 - start, 0), c - 1)
    return _logits(cfg, qp, x[:, idx]), cache


def serve_step(cfg, qp, cache, tokens, *, use_lop=True, active=None):
    """One decode step. tokens [B, 1] → (logits [B, V], cache).

    Only the lanes of ``active`` (bool [B]; by default the pool's own
    ``"active"`` mask, and every lane of a cache without one) decode: the
    others write nothing and keep their lengths. The cache is updated in
    place and no entry of it is rebound, so a CUDA graph of the step stays
    valid for the same cache.
    """
    cfg = resolve_decode_flags(cfg)
    _check_dense(cfg)
    lengths = cache["lengths"]
    if active is None:
        active = cache.get("active")
    x = embedding_apply(qp["embed"], tokens)
    for i in range(cfg.n_layers):
        lp = layer_slice(qp["layers"], i)
        cl = layer_slice(cache["layers"], i)
        x = x + attn_decode(cfg, lp["attn"],
                            norm_apply(lp["ln1"], x, cfg.norm), cl, lengths,
                            use_lop=use_lop, active=active)
        x = _mlp(cfg, lp, x)
    lengths.add_(1 if active is None else active.to(torch.int32))
    return _logits(cfg, qp, x[:, -1]), cache


def guard_logits(logits, fault_add):
    """Fault-injection and detection point of the decode step: adds the
    per-lane offset ``fault_add`` f32 [B] (NaN rows when a
    :mod:`repro_torch.serving.faults` plan injects; zeros in production,
    as the reference passes) and computes each lane's finiteness on the
    logits' device — one reduction, no [B, V] host transfer. → (logits
    [B, V], ok bool [B]). A lane with ``ok`` False must not emit its
    sampled token."""
    logits = logits + fault_add[:, None]
    return logits, torch.isfinite(logits).all(dim=-1)
