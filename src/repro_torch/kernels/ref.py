"""Plain PyTorch versions of the port's kernels: the five of the serving
path and the four standalone building blocks (the TINT GEMM, the LOP
screen, single-head flash prefill and block-sparse decode).

Each function repeats its kernel's arithmetic with plain tensor ops and
runs on the CPU and on the card alike: the wrappers in
:mod:`repro_torch.kernels.ops` take them for CPU tensors, and
``chip_smoke.py`` holds each CUDA kernel against them on the card.

Integer products never go through an integer matmul (CUDA has none, and
an int8 matmul on the CPU wraps): they are formed as float64 matmuls of the
int values, which are exact far beyond these magnitudes, then cast to
int32. The attention weights·values product is also taken in float64 and
rounded once to f32, so a query row's result does not depend on how many
rows share the call — the chunked-prefill invariant.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.lop import features_to_pot, pot, unpack_features
from repro_torch.core.quantization import int_matmul, quantize
from repro_torch.core.ternary import unpack_ternary

NEG_INF = -1e30


def apply_act(y: torch.Tensor, act: str | None) -> torch.Tensor:
    """Epilogue nonlinearity; ``gelu`` is the tanh form (``jax.nn.gelu``)."""
    if act is None:
        return y
    if act == "silu":
        return F.silu(y)
    if act == "gelu":
        return F.gelu(y, approximate="tanh")
    raise ValueError(f"unknown activation {act!r}")


def qlinear_ref(x, packed, scale, bias=None, *, act=None):
    """The fused TINT projection, written out.

    absmax barrier → packed-ternary × int8 GEMM → ``(acc·x_scale)·γ`` →
    bias → act. x f32 [..., k] with packed [k//4, n] (or the grouped-expert
    form x [E, C, k] with packed [E, k//4, n]); scale f32 per-column γ row
    broadcastable to [..., 1, n]. → f32 [..., n].
    """
    k = packed.shape[-2] * 4
    xq = quantize(x)
    w = unpack_ternary(packed, k)
    acc = int_matmul(xq.values, w)
    y = acc.to(torch.float32) * xq.scale * scale
    if bias is not None:
        y = y + bias
    return apply_act(y, act)


def ffn_fused_ref(x, gu_packed, gu_scale, down_packed, down_scale, *,
                  gated: bool, act: str):
    """The whole FFN: ``act(x·Wg)·(x·Wu)`` → absmax barrier → ``·Wd``."""
    f = down_packed.shape[-2] * 4
    h_all = qlinear_ref(x, gu_packed, gu_scale)
    if gated:
        h = apply_act(h_all[..., :f], act) * h_all[..., f:]
    else:
        h = apply_act(h_all, act)
    return qlinear_ref(h, down_packed, down_scale)


def _guarded_softmax_out(s, vf):
    """Masked logits [.., R, M] and dequantized values [.., M, d] → the
    normalized output, with fully-masked rows emitting exact zero."""
    mx = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.clamp_min(mx, -1e29))
    p = torch.where(s <= NEG_INF / 2, 0.0, p)
    l = p.to(torch.float64).sum(-1, keepdim=True).to(torch.float32)
    acc = torch.matmul(p.to(torch.float64), vf.to(torch.float64)).to(
        torch.float32)
    return mx, l, acc


def prefill_attention_ref(qi, qsc, k_cache, v_cache, k_scale, v_scale,
                          kv_len, q_off=0, *, causal: bool = True,
                          window: int = 0, softmax_scale: float,
                          int8_logits: bool = False) -> torch.Tensor:
    """Batched GQA prefill-chunk attention.

    qi int8 [B, H, C, dh]; qsc f32 [B, H, C]; caches [B, Hkv, M, ...];
    kv_len int32 [B]; ``q_off`` is the global position of query column 0.
    Logits scale as ``((s·k_scale)·q_scale)·softmax_scale``. Both
    ``int8_logits`` settings are the same exact integer dot here.
    → f32 [B, H, C, dh].
    """
    del int8_logits
    b, h, c, dh = qi.shape
    hkv, m = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    dev = qi.device
    qg = qi.reshape(b, hkv, g * c, dh)
    s = int_matmul(qg, k_cache.transpose(-1, -2)).to(torch.float32)
    s = s * k_scale[:, :, None, :] * qsc.reshape(b, hkv, g * c, 1) \
        * softmax_scale
    kpos = torch.arange(m, device=dev)
    qpos = int(q_off) + torch.arange(c, device=dev).repeat(g)    # row g·C+t
    mask = kpos[None, None, :] < kv_len.to(dev)[:, None, None]   # [B,1,M]
    if causal:
        mask = mask & (qpos[None, :, None] >= kpos[None, None, :])
        if window:
            mask = mask & ((qpos[None, :, None] - kpos[None, None, :])
                           < window)
    s = torch.where(mask[:, None], s, NEG_INF)
    vf = v_cache.to(torch.float32) * v_scale[..., None]
    _, l, acc = _guarded_softmax_out(s, vf)
    o = acc / torch.where(l > 0, l, torch.ones_like(l))
    return o.reshape(b, h, c, dh)


def _gather_blocks(arr, idx, block):
    """arr [B, Hkv, M, ...], idx [B, Hkv, G', K] → [B, Hkv, G', K·block, ...]."""
    b, hkv, m = arr.shape[:3]
    rest = arr.shape[3:]
    gsel, kk = idx.shape[2], idx.shape[3]
    blocks = arr.reshape(b, hkv, 1, m // block, block * math.prod(rest))
    blocks = blocks.expand(b, hkv, gsel, m // block, blocks.shape[-1])
    gi = idx.to(torch.int64)[..., None].expand(b, hkv, gsel, kk,
                                                blocks.shape[-1])
    out = torch.gather(blocks, 3, gi)
    return out.reshape(b, hkv, gsel, kk * block, *rest)


def decode_attention_ref(qi, qsc, k_cache, v_cache, k_scale, v_scale, feat,
                         new_len, *, block: int, k_keep: int, window: int,
                         softmax_scale: float, use_lop: bool = True,
                         shared_select: bool = False, pos_offset=None,
                         return_stats: bool = False):
    """Batched decode attention: LOP screen → select → exact, or dense.

    qi int8 [B, H, dh]; qsc f32 [B, H, 1]; caches [B, Hkv, M, ...]; feat
    uint8 [B, Hkv, M, dh//2]; new_len int32 [B] (0 → the lane emits exact
    zero). Logits scale as ``((s·q_scale)·k_scale)·softmax_scale``.
    → f32 [B, H, dh]; with ``return_stats`` also (m, ℓ) f32 [B, H, 1].
    """
    from repro_torch.serving.lop_select import select_blocks, token_valid_mask

    b, h, dh = qi.shape
    hkv, m = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    po = 0 if pos_offset is None else int(pos_offset)
    qg = qi.reshape(b, hkv, g, dh)
    qs = qsc.reshape(b, hkv, g, 1)

    if not use_lop:
        s = int_matmul(qg, k_cache.transpose(-1, -2)).to(torch.float32)
        s = s * qs * k_scale[:, :, None, :] * softmax_scale
        valid = token_valid_mask(m, new_len, window, pos_offset=po)
        s = torch.where(valid[:, None, None, :], s, NEG_INF)
        vf = v_cache.to(torch.float32) * v_scale[..., None]
        mx, l, acc = _guarded_softmax_out(s, vf)
        return _stats_to_out(mx, l, acc, b, h, dh, return_stats)

    kp = features_to_pot(unpack_features(feat))          # [B,Hkv,M,dh]
    scores = int_matmul(pot(qg), kp.transpose(-1, -2))   # [B,Hkv,G,M]
    if shared_select:
        scores = scores.amax(2, keepdim=True)
    idx, gate_tokens = select_blocks(scores, new_len, block=block,
                                     k_keep=k_keep, window=window,
                                     block_offset=po // block)
    k_sel = _gather_blocks(k_cache, idx, block)          # [B,Hkv,G',K·bl,dh]
    v_sel = _gather_blocks(v_cache, idx, block)
    ks_sel = _gather_blocks(k_scale, idx, block)         # [B,Hkv,G',K·bl]
    vs_sel = _gather_blocks(v_scale, idx, block)
    # [B,Hkv,G,1,dh] × [B,Hkv,G',dh,K·bl] broadcasts G' = 1 over G
    s = int_matmul(qg[:, :, :, None, :], k_sel.transpose(-1, -2))[..., 0, :]
    s = s.to(torch.float32) * qs * ks_sel * softmax_scale

    kk = idx.shape[-1]
    gate = gate_tokens[..., :kk] > 0
    end = gate_tokens[..., kk:2 * kk]
    start = gate_tokens[..., 2 * kk:]
    t = torch.arange(block, device=qi.device)
    live = ((t >= start[..., None]) & (t < end[..., None]) & gate[..., None])
    live = live.reshape(b, hkv, idx.shape[2], kk * block)
    s = torch.where(live, s, NEG_INF)
    vf = v_sel.to(torch.float32) * vs_sel[..., None]     # [B,Hkv,G',K·bl,dh]
    mx, l, acc = _guarded_softmax_out(s[:, :, :, None, :], vf)
    return _stats_to_out(mx[..., 0, :], l[..., 0, :], acc[..., 0, :],
                         b, h, dh, return_stats)


def _stats_to_out(m, l, acc, b, h, dh, return_stats):
    out = (acc / torch.where(l > 0, l, torch.ones_like(l))).reshape(b, h, dh)
    if return_stats:
        return out, m.reshape(b, h, 1), l.reshape(b, h, 1)
    return out


# ---------------------------------------------------------------------------
# Standalone building blocks
# ---------------------------------------------------------------------------

def ternary_matmul_ref(x, packed, k: int) -> torch.Tensor:
    """int8 x [..., k] × packed ternary [k//4, n] → raw int32 [..., n]."""
    return int_matmul(x, unpack_ternary(packed, k))


def lop_scores_ref(q_pot, packed_feat) -> torch.Tensor:
    """Surrogate scores from the packed feature cache. pot-rounded int8
    queries [..., g, d] × packed (sgn‖LO) features [..., m, d//2] →
    int32 [..., g, m]; leading dims are lanes."""
    kp = features_to_pot(unpack_features(packed_feat))
    return int_matmul(q_pot, kp.transpose(-1, -2))


def flash_prefill_ref(q, k, v, q_scale, k_scale, v_scale, *,
                      softmax_scale: float, causal: bool = True,
                      window: int = 0) -> torch.Tensor:
    """One head of causal / sliding-window / non-causal int8 attention.

    q/k/v int8 [s, d]; per-token scales f32 [s, 1] → f32 [s, d]. Logits
    scale as ``((dot·q_scale)·k_scale)·softmax_scale``; every causal row
    sees its own diagonal, so no row is fully masked.
    """
    s = q.shape[0]
    logits = int_matmul(q, k.transpose(0, 1)).to(torch.float32)
    logits = logits * q_scale * k_scale.reshape(1, s) * softmax_scale
    if causal:
        pos = torch.arange(s, device=q.device)
        rel = pos[:, None] - pos[None, :]
        mask = rel >= 0
        if window:
            mask = mask & (rel < window)
        logits = torch.where(mask, logits, NEG_INF)
    vf = v.to(torch.float32) * v_scale
    _, l, acc = _guarded_softmax_out(logits, vf)
    return acc / torch.where(l > 0, l, torch.ones_like(l))


def sparse_decode_attention_ref(q, k_cache, v_cache, q_scale, k_scale,
                                v_scale, block_idx, gate_tokens, *,
                                block: int,
                                softmax_scale: float) -> torch.Tensor:
    """Decode attention over caller-chosen K/V blocks, lane-batched.

    q int8 [L, g, d]; q_scale f32 [L, g, 1]; k/v_cache int8 [C, m, d];
    k/v_scale f32 [C, m, 1], L a multiple of C: lane l reads cache lane
    l // (L // C); block_idx int32 [L, nb] (clamped into range, as a gather
    does); gate_tokens int32 [L, 3·nb] = [gate ‖ end ‖ start]. → f32
    [L, g, d].

    The blocks fold in the given order into an online softmax, as the
    kernel walks them: a block with gate 0 is skipped; tokens outside its
    [start, end) get −1e30; m' = max(m, max s), α = exp(m − m'), p =
    exp(s − m'), ℓ = ℓα + Σp, acc = acc·α + p·(v·v_scale); the flush
    divides only where ℓ > 0, so a lane whose gates are all 0 emits exact
    zero.
    """
    n_lanes, g, d = q.shape
    n_cache, m = k_cache.shape[:2]
    nbt = m // block
    nb = block_idx.shape[-1]
    dev = q.device
    cl = (torch.arange(n_lanes, device=dev) // (n_lanes // n_cache))[:, None]
    idx = block_idx.to(torch.int64).clamp(0, nbt - 1)
    kb = k_cache.reshape(n_cache, nbt, block, d)[cl, idx]   # [L,nb,block,d]
    vb = v_cache.reshape(n_cache, nbt, block, d)[cl, idx]
    ksb = k_scale.reshape(n_cache, nbt, block)[cl, idx]     # [L,nb,block]
    vsb = v_scale.reshape(n_cache, nbt, block)[cl, idx]
    gate = gate_tokens[:, :nb] > 0
    end = gate_tokens[:, nb:2 * nb]
    start = gate_tokens[:, 2 * nb:]
    t = torch.arange(block, device=dev)
    m_run = torch.full((n_lanes, g, 1), NEG_INF, dtype=torch.float32,
                       device=dev)
    l_run = torch.zeros((n_lanes, g, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((n_lanes, g, d), dtype=torch.float32, device=dev)
    for j in range(nb):
        s = int_matmul(q, kb[:, j].transpose(-1, -2)).to(torch.float32)
        s = s * q_scale * ksb[:, j, None, :] * softmax_scale
        live = (t >= start[:, j, None]) & (t < end[:, j, None])
        s = torch.where(live[:, None, :], s, NEG_INF)
        m_new = torch.maximum(m_run, s.amax(-1, keepdim=True))
        alpha = torch.exp(m_run - m_new)
        p = torch.exp(s - m_new)
        vf = vb[:, j].to(torch.float32) * vsb[:, j, :, None]
        pv = torch.matmul(p.to(torch.float64), vf.to(torch.float64)).to(
            torch.float32)
        on = gate[:, j, None, None]
        l_run = torch.where(on, l_run * alpha + p.sum(-1, keepdim=True),
                            l_run)
        acc = torch.where(on, acc * alpha + pv, acc)
        m_run = torch.where(on, m_new, m_run)
    return acc / torch.where(l_run > 0, l_run, torch.ones_like(l_run))
