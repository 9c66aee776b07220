"""Head-level streaming schedule (the paper's §III-B, Fig. 9).

The ASIC's one-head-offset pipeline (TINT computes Q/K/V for head h+1
while BoothFlex runs attention for head h) exists so that no buffer ever
holds every head's Q/K/V. Here that is a loop over head *groups* whose
body projects one group, attends over it and adds its slice of the
output projection into an output-stationary accumulator: no full
[B, S, 3·H·d] buffer exists, and the live activations are one group's.
The conventional schedule (every head's Q/K/V, then attention) is the
ablation baseline of Fig. 9.

The reference computes these products outside Pallas, so here they stay
``torch.matmul``: no kernel of the port runs in this module.
"""

from __future__ import annotations

import torch


def materialized_mha(x, wq, wk, wv, wo, *, n_heads: int, head_dim: int,
                     attn_fn):
    """Conventional schedule: Q/K/V for ALL heads, then attention.

    x [B, S, D]; wq/wk/wv [D, H·d]; wo [H·d, D]; attn_fn(q, k, v) → o over
    q/k/v [B, S, H, d]. → [B, S, D].
    """
    b, s, _ = x.shape
    q = (x @ wq).reshape(b, s, n_heads, head_dim)
    k = (x @ wk).reshape(b, s, n_heads, head_dim)
    v = (x @ wv).reshape(b, s, n_heads, head_dim)
    o = attn_fn(q, k, v)                              # [B, S, H, d]
    return o.reshape(b, s, n_heads * head_dim) @ wo


def streamed_mha(x, wq, wk, wv, wo, *, n_heads: int, head_dim: int,
                 attn_fn, group: int = 1):
    """Head-level streaming: a loop over groups of ``group`` heads; each
    step projects one group, attends and accumulates its slice of the
    output projection. The live Q/K/V are one group's instead of H heads';
    the output is accumulated output-stationary, as the paper's dataflow.
    """
    b, s, dm = x.shape
    if n_heads % group:
        raise ValueError(f"{n_heads} heads are not a multiple of group "
                         f"{group}")
    gd = group * head_dim
    acc = torch.zeros((b, s, dm), dtype=x.dtype, device=x.device)
    for i in range(n_heads // group):
        cols = slice(i * gd, (i + 1) * gd)
        q = (x @ wq[:, cols]).reshape(b, s, group, head_dim)
        k = (x @ wk[:, cols]).reshape(b, s, group, head_dim)
        v = (x @ wv[:, cols]).reshape(b, s, group, head_dim)
        o = attn_fn(q, k, v).reshape(b, s, gd)
        acc = acc + o @ wo[cols]
    return acc


def standard_softmax_attention(q, k, v, *, causal: bool = True):
    """Per-head attention both schedules use: q/k/v [B, S, H, d] → the
    same shape."""
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / (d ** 0.5)
    if causal:
        s = q.shape[1]
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                     device=q.device))
        logits = logits.masked_fill(~mask[None, None], -1e30)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)
