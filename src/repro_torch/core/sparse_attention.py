"""Predictive sparse attention, the paper's system view (§III-A).

Decode-time flow per (batch, query head):

    1. screen — surrogate scores over all M cached tokens from the 4-bit
       LOP features (an exact pot-dot in int32),
    2. select — comparison-free top-K at block granularity, so the K/V
       reads are short contiguous blocks,
    3. gather — only the K candidate blocks of exact int8 K/V,
    4. exact  — softmax attention confined to the candidates.

Plain tensor code, every (batch, kv-head, group) lane at once; the
serving path runs the same flow in one kernel
(:func:`repro_torch.kernels.ops.decode_attention`).
"""

from __future__ import annotations

import torch

from repro_torch.core import lop
from repro_torch.core.quantization import int_matmul, online_softmax_stats

NEG_INF = -1e30
INT32_MIN = -2 ** 31


def _gather_blocks(x: torch.Tensor, block_idx: torch.Tensor,
                   block: int) -> torch.Tensor:
    """x [B, Hkv, M, ...], block_idx [B, Hkv, G, K] → [B, Hkv, G, K·block,
    ...]: the candidate blocks of each query head's kv head."""
    b, hkv, m = x.shape[:3]
    rest = x.shape[3:]
    g, kk = block_idx.shape[2:]
    xb = x.reshape(b, hkv, 1, m // block, block, *rest)
    xb = xb.expand(b, hkv, g, *xb.shape[3:])
    bi = torch.arange(b, device=x.device)[:, None, None, None]
    hi = torch.arange(hkv, device=x.device)[None, :, None, None]
    gi = torch.arange(g, device=x.device)[None, None, :, None]
    out = xb[bi, hi, gi, block_idx.to(torch.int64)]      # [B,Hkv,G,K,block,..]
    return out.reshape(b, hkv, g, kk * block, *rest)


def predictive_sparse_attention(q, k_cache, v_cache, feat_cache, valid, *,
                                k_blocks: int, block: int = 64,
                                n_buckets: int = 64,
                                softmax_scale: float | None = None):
    """Batched decode attention through the LOP screen.

    q int8 [B, H, d] (one new token per sequence); k/v_cache int8
    [B, Hkv, M, d]; feat_cache uint8 [B, Hkv, M, d] (unpacked nibbles);
    valid bool [B, M]. → f32 [B, H, d], before the q/k/v scales.
    """
    b, h, d = q.shape
    hkv, m = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    if softmax_scale is None:
        softmax_scale = 1.0 / (d ** 0.5)
    qg = q.reshape(b, hkv, g, d)

    # 1. screen
    kp = lop.features_to_pot(feat_cache)
    s_hat = int_matmul(lop.pot(qg), kp.transpose(-1, -2))   # [B,Hkv,G,M]

    # 2. comparison-free block top-K
    tok_ok = valid[:, None, None, :]
    blk_valid = valid.reshape(b, m // block, block).any(-1)
    blk_scores = lop.block_reduce_scores(
        torch.where(tok_ok, s_hat, INT32_MIN), block)
    blk_idx, blk_gate = lop.comparison_free_topk(
        blk_scores, k_blocks, n_buckets=n_buckets,
        valid=blk_valid[:, None, None, :].expand_as(blk_scores))

    # 3. gather only the candidate blocks
    k_sel = _gather_blocks(k_cache, blk_idx, block)          # [B,Hkv,G,K·bl,d]
    v_sel = _gather_blocks(v_cache, blk_idx, block)
    valid_kv = valid[:, None, :].expand(b, hkv, m)
    tok_valid = (_gather_blocks(valid_kv, blk_idx, block)
                 & blk_gate.repeat_interleave(block, dim=-1))

    # 4. exact attention confined to the candidates
    logits = int_matmul(qg[..., None, :], k_sel.transpose(-1, -2))[
        ..., 0, :].to(torch.float32) * softmax_scale
    logits = torch.where(tok_valid, logits, NEG_INF)
    mx, se = online_softmax_stats(logits)
    p = torch.exp(logits - mx) / se
    out = torch.matmul(p[..., None, :], v_sel.to(torch.float32))[..., 0, :]
    return out.reshape(b, h, d)


def dense_reference_attention(q, k_cache, v_cache, valid,
                              softmax_scale: float | None = None):
    """No-LOP oracle: exact attention over every valid cached token.
    Shapes as :func:`predictive_sparse_attention`."""
    b, h, d = q.shape
    hkv = k_cache.shape[1]
    g = h // hkv
    if softmax_scale is None:
        softmax_scale = 1.0 / (d ** 0.5)
    qg = q.reshape(b, hkv, g, d)
    logits = int_matmul(qg, k_cache.transpose(-1, -2)).to(
        torch.float32) * softmax_scale
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.matmul(p, v_cache.to(torch.float32))
    return out.reshape(b, h, d)
