"""LOP screen → comparison-free block top-K selection (batched form).

``select_blocks`` turns surrogate token scores into, per selection set,
``block_idx`` int32 [K] and ``gate_tokens`` int32 [3K] = [gate ‖ end ‖
start]: whether the candidate is live and which tokens [start, end) of its
block survive the cache-length cut and the window cut. The CUDA decode
kernel re-derives the same ranks, gates and intervals from ``new_len``.
"""

from __future__ import annotations

import torch

from repro_torch.core.lop import (DEFAULT_N_BUCKETS, block_reduce_scores,
                                  comparison_free_topk)

INT32_MIN = -2 ** 31


def token_valid_mask(m: int, new_len: torch.Tensor, window: int,
                     pos_offset: int = 0) -> torch.Tensor:
    """[B, M] bool — cache positions visible to the current query."""
    pos = pos_offset + torch.arange(m, device=new_len.device)[None, :]
    valid = pos < new_len[:, None]
    if window:
        valid = valid & (pos >= new_len[:, None] - window)
    return valid


def select_blocks(scores: torch.Tensor, new_len: torch.Tensor, *, block: int,
                  k_keep: int, window: int = 0,
                  n_buckets: int = DEFAULT_N_BUCKETS, block_offset: int = 0):
    """scores int32 [B, Hkv, G, M]; new_len int32 [B] →
    (block_idx [B, Hkv, G, K], gate_tokens [B, Hkv, G, 3K])."""
    b, hkv, g, m = scores.shape
    nb = m // block
    valid = token_valid_mask(m, new_len, window,
                             pos_offset=block_offset * block)
    s_masked = torch.where(valid[:, None, None, :], scores, INT32_MIN)
    blk = block_reduce_scores(s_masked, block)            # [B,Hkv,G,NB]
    blk_valid = valid.reshape(b, nb, block).any(-1)       # [B,NB]
    blk_valid = blk_valid[:, None, None, :].expand(b, hkv, g, nb)
    idx, gate = comparison_free_topk(blk, k_keep, n_buckets=n_buckets,
                                     valid=blk_valid)
    blk_start = (idx + block_offset) * block
    len_b = new_len[:, None, None, None].to(torch.int32)
    end = (len_b - blk_start).clamp(0, block)
    if window:
        start = (len_b - window - blk_start).clamp(0, block)
    else:
        start = torch.zeros_like(end)
    gate_tokens = torch.cat([gate.to(torch.int32), end.to(torch.int32),
                             start.to(torch.int32)], dim=-1)
    return idx, gate_tokens


def k_keep_blocks(cfg, m: int) -> int:
    """Static K (blocks kept) for a capacity-M cache: round(keep·M/block)."""
    nb = m // cfg.lop_block
    return max(1, int(round(cfg.lop_keep * nb)))
