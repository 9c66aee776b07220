"""Training attention: the f32 chunked schedule of exact attention and the
whole block (projections, RoPE, attention, output projection) — the
reference's ``models/attention.py``, which the serving engine does not
call (it runs the int8 kernels #1 and #3–#5).

Queries go in chunks of ``chunk`` rows (the last padded with zero rows
and cut off after), each chunk's logits in f32 over every key, masked
(causal, sliding window) in absolute positions, a softmax in f32, then
P·V in f32 rounded to q's dtype. GQA repeats each key/value head over its
group of query heads, as the reference does.

The reference's sharding constraints (``shard_heads_or_seq``) are not
copied: on one card, placing heads or the sequence on a model axis is
the identity. Its ``REPRO_ATTN_CHUNK`` environment
read, a knob of its dry-run cost accounting (tiling is flop- and
byte-invariant), is not copied: the chunk is an argument.
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import linear_apply, rope

NEG_INF = -1e30


def chunked_attention(q, k, v, *, causal: bool, window: int = 0,
                      q_offset: int = 0, chunk: int = 512,
                      softmax_scale: float | None = None) -> torch.Tensor:
    """q [B, Sq, H, dh]; k/v [B, Skv, Hkv, dh] (H % Hkv == 0) → [B, Sq, H,
    dh] in q's dtype. ``window > 0`` adds the sliding-window mask;
    ``q_offset`` is the absolute position of q's first row (a chunk of a
    longer stream)."""
    b, sq, h, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if softmax_scale is None:
        softmax_scale = dh ** -0.5
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    chunk = min(chunk, sq)
    pad = -sq % chunk
    if pad:
        q = torch.cat([q, q.new_zeros((b, pad, h, dh))], dim=1)
    kpos = torch.arange(skv, device=q.device)
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    out = []
    for start in range(0, sq + pad, chunk):
        qi = q[:, start:start + chunk].to(torch.float32)
        logits = torch.einsum("bqhd,bkhd->bhqk", qi, kf) * softmax_scale
        qpos = q_offset + start + torch.arange(chunk, device=q.device)
        mask = torch.ones((chunk, skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= qpos[:, None] >= kpos[None, :]
        if window:
            mask &= (qpos[:, None] - kpos[None, :]) < window
        logits = torch.where(mask, logits, NEG_INF)
        p = torch.softmax(logits, dim=-1)
        out.append(torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype))
    return torch.cat(out, dim=1)[:, :sq]


def attention_apply(cfg, p, x, *, kv_x=None, causal=True, positions=None,
                    use_rope=True, chunk_carry: bool = False,
                    q_offset: int = 0):
    """Self-attention (``kv_x`` None), cross-attention (``kv_x`` the
    encoder memory: non-causal, no RoPE, no window, whatever ``use_rope``
    says), or chunk-carry (``kv_x`` the whole stream prefix ‖ chunk with
    ``chunk_carry=True`` and the chunk's absolute start ``q_offset``: keys
    roped at [0, S_kv), queries at [q_offset, q_offset + S), so the
    chunk's rows equal the same rows of one whole-stream call). x [B, S,
    D] → [B, S, D]; the projections are QAT BitLinears (bias when the
    node has one)."""
    b, sq, _ = x.shape
    src = x if kv_x is None else kv_x
    skv = src.shape[1]
    self_like = kv_x is None or chunk_carry

    q = linear_apply(p["wq"], x, quant=cfg.quant)
    k = linear_apply(p["wk"], src, quant=cfg.quant)
    v = linear_apply(p["wv"], src, quant=cfg.quant)
    q = q.reshape(b, sq, cfg.n_heads, cfg.hd)
    k = k.reshape(b, skv, cfg.n_kv_heads, cfg.hd)
    v = v.reshape(b, skv, cfg.n_kv_heads, cfg.hd)

    if use_rope and self_like:
        if positions is None:
            positions = q_offset + torch.arange(sq, device=x.device)[None, :]
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, torch.arange(skv, device=x.device)[None, :]
                 if chunk_carry else positions, cfg.rope_theta)

    o = chunked_attention(q, k, v, causal=causal and self_like,
                          window=cfg.swa_window if self_like else 0,
                          q_offset=q_offset)
    return linear_apply(p["wo"], o.reshape(b, sq, cfg.q_dim),
                        quant=cfg.quant)
