"""Serving engine, every family: prefill (whole prompt, and chunked for
dense and vlm) and the one-token decode step.

Per decoder layer the path makes four kernel dispatches through
:mod:`repro_torch.kernels.ops`: the fused QKV projection, prefill or decode
attention, the O projection, and the whole FFN — for a moe layer the
grouped-expert FFN of every expert in one launch, between the router and
the combine (:mod:`repro_torch.models.moe`). Everything between them
(RMSNorm, RoPE, the absmax quantization of q/k/v, LOP features, cache
writes, the f32 head) is plain tensor code. Layers are a Python loop over
the layer-stacked weights.

The encdec family (whisper) prefills its encoder first: each encoder
layer's self-attention is #3 non-causal over the unpadded encoder frames
(no RoPE, no cache), then ``ln_enc``. Each decoder layer quantizes the
encoder memory through its cross-attention K/V projection into the
cache's ``cross`` pages (:func:`build_cross_cache`) and attends them
after its self-attention: #3 non-causal at prefill
(:func:`cross_attn_prefill`), the decode kernel at decode
(:func:`cross_attn_decode`) with ``new_len = cross_len`` and no write.

The cache is written in place: prefill writes each layer's K/V/features
into a preallocated capacity-padded cache, a chunk writes its rows at
``[start, start + C)`` of the lane it was given (a view into the pool), and
a decode step appends one token per active lane. Self-speculative decoding
(DESIGN.md §Speculative-decoding) adds the draft step — the first
``draft_layers`` layers with the LOP budget pinched to ``draft_k`` blocks,
then the shared head — and the verify chunk, :func:`prefill_chunk` with
``all_logits=True``.

The recurrent families carry state instead of (or beside) pages. An ssm
(rwkv6) layer runs :func:`repro_torch.models.rwkv6.rwkv_time_mix` and
``rwkv_channel_mix`` — ten #1 launches and the wkv recurrence in plain
tensor ops — over the whole prompt from zero states at prefill and over
one token at decode (:func:`_rwkv_layer`). A hybrid (jamba) superblock
runs its ``attn_every`` sublayers in order: the attention one as a
decoder layer over the superblock's pages (#3 over the prompt's block
roundup, as moe does; #4/#5 at decode), the others as Mamba sublayers
(:func:`_mamba_layer`), each with its FFN or MoE. Every state update
writes the cache's own tensors in place, for every lane: as in the
reference, a recurrent state ignores ``active`` (an inactive lane's state
is never read, and an insert overwrites it), so a retry steps every
lane's state once more.

The vlm family (llava) is the dense layer stack behind an image prefix:
a request's stub patch embeddings f32 [n_img, D] go through the f32
``projector`` (a plain product, :func:`_embed`) and stand before the text
embeddings, so the image's rows take cache positions [0, n_img) and text
token t position n_img + t. Chunked, the image rides the first chunk
(embedded width n_img + C at start 0) and later chunks start past it;
decode is the dense step.

With ``sp_axes`` and an active mesh (:mod:`repro_torch.distributed`) the
decode step runs the sequence-parallel attention of
:mod:`repro_torch.distributed.sp_decode`, as the reference's production
path does: the cache's token axis is sharded over the mesh axes
(:func:`shard_cache` cuts a replicated prefill's cache to a rank's
shard), each shard calls the same decode kernel with its ``pos_offset``,
and the softmax stats merge flash-decoding style.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import resolve_decode_flags
from repro_torch.core.lop import lop_features, pack_features
from repro_torch.core.qlinear import qlinear, qlinear_split
from repro_torch.core.quantization import quantize
from repro_torch.kernels import ops
from repro_torch.models import rwkv6
from repro_torch.models.layers import (embedding_apply, ffn_apply, head_apply,
                                       norm_apply, rope)
from repro_torch.models.mamba import mamba_decode_step, mamba_forward
from repro_torch.models.moe import moe_apply
from repro_torch.models.transformer import layer_slice
from repro_torch.serving.cache import init_cache, round_up
from repro_torch.serving.lop_select import k_keep_blocks


def _q(x):
    qt = quantize(x)
    return qt.values, qt.scale


SERVED_FAMILIES = ("dense", "moe", "encdec", "ssm", "hybrid", "vlm")
# the families whose per-token compute does not depend on how the prompt
# is split: they prefill in chunks, speculate and cache prefixes
CHUNKED_FAMILIES = ("dense", "vlm")


def _check_family(cfg, families=SERVED_FAMILIES, what: str = "") -> None:
    if cfg.family not in families:
        raise NotImplementedError(f"family {cfg.family!r} is not ported"
                                  + (f" for {what}" if what else ""))


def chunks_prefill(cfg) -> bool:
    """Whether ``cfg``'s family prefills in chunks over the full capacity.
    moe routers rank a group's tokens for expert capacity, so a pad token
    or a chunk boundary would change who is dropped, and an encdec prompt
    is prefilled with its encoder frames: both prefill whole prompts at
    their exact length (run to completion) and attend only their block
    roundup."""
    return cfg.family in CHUNKED_FAMILIES


def _project_qkv(cfg, lp, h):
    b, s, _ = h.shape
    q, k, v = qlinear_split(lp["wqkv"], h, (cfg.q_dim, cfg.kv_dim,
                                            cfg.kv_dim))
    return (q.reshape(b, s, cfg.n_heads, cfg.hd),
            k.reshape(b, s, cfg.n_kv_heads, cfg.hd),
            v.reshape(b, s, cfg.n_kv_heads, cfg.hd))


def _quantize_kv(k, v, features: bool = True):
    """[B, S, Hkv, dh] f32 → int8 K/V, scales and packed features (None
    with ``features=False``) in the cache's [B, Hkv, S, ...] layout."""
    ki, ksc = _q(k)
    vi, vsc = _q(v)
    ki = ki.transpose(1, 2)
    vi = vi.transpose(1, 2)
    ksc = ksc[..., 0].transpose(1, 2)
    vsc = vsc[..., 0].transpose(1, 2)
    return (ki, vi, ksc, vsc,
            pack_features(lop_features(ki)) if features else None)


def _write_rows(cl, ki, vi, ksc, vsc, feat, start: int) -> None:
    """Write S quantized tokens at [start, start + S) of a cache layer (in
    place)."""
    s = ki.shape[2]
    cl["k"][:, :, start:start + s] = ki
    cl["v"][:, :, start:start + s] = vi
    cl["k_scale"][:, :, start:start + s] = ksc
    cl["v_scale"][:, :, start:start + s] = vsc
    cl["feat"][:, :, start:start + s] = feat


def _attend_prefill(cfg, lp, h, cl, *, start: int, kv_len,
                    m_att: int | None = None):
    """Shared body of whole-prompt and chunked prefill attention; the
    attention reads cache positions [0, m_att) (all of them by default)."""
    b, s, _ = h.shape
    q, k, v = _project_qkv(cfg, lp, h)
    positions = start + torch.arange(s, device=h.device)[None, :]
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    qi, qsc = _q(q)
    _write_rows(cl, *_quantize_kv(k, v), start)
    view = {key: cl[key][:, :, :m_att] for key in ("k", "v", "k_scale",
                                                   "v_scale")}
    o = ops.prefill_attention(
        qi.transpose(1, 2), qsc[..., 0].transpose(1, 2), view["k"],
        view["v"], view["k_scale"], view["v_scale"], kv_len, q_offset=start,
        causal=True,
        window=cfg.swa_window, int8_logits=bool(cfg.int8_logits))
    o = o.transpose(1, 2).reshape(b, s, cfg.q_dim)
    return qlinear(lp["wo"], o)


def attn_prefill(cfg, lp, h, cl):
    """Whole-prompt attention; writes K/V/features at [0, S) of ``cl``.

    The prompt is one maximal chunk over the full capacity-padded cache
    (``q_offset`` 0, ``kv_len`` S) — the same op and operand shapes as
    :func:`attn_prefill_chunk`, which is what keeps chunked prefill
    bitwise whole-prompt prefill. A family that never chunks (moe) attends
    only the prompt's block roundup, ``min(capacity, round_up(S,
    lop_block))``, as the reference does: its cost scales with S, not
    with the pool's capacity.
    """
    b, s, _ = h.shape
    kv_len = torch.full((b,), s, dtype=torch.int32, device=h.device)
    m_att = None if chunks_prefill(cfg) else min(
        cl["k"].shape[2], round_up(s, cfg.lop_block))
    return _attend_prefill(cfg, lp, h, cl, start=0, kv_len=kv_len,
                           m_att=m_att)


def attn_prefill_chunk(cfg, lp, h, cl, *, start: int, kv_len):
    """One C-token chunk at global positions [start, start + C) against a
    cache layer holding every earlier chunk's K/V at [0, start)."""
    return _attend_prefill(cfg, lp, h, cl, start=start, kv_len=kv_len)


def _to_rows(qi, qsc):
    """Quantized queries [B, S, H, dh] and scales [B, S, H, 1] → the
    prefill kernel's [B, H, S, dh] and [B, H, S]."""
    return qi.transpose(1, 2), qsc[..., 0].transpose(1, 2)


def encoder_layer(cfg, lp, e):
    """One encoder layer: self-attention over the unpadded frames (#3
    non-causal, no RoPE, nothing cached), then the FFN. e [B, S_enc, D]."""
    b, s, _ = e.shape
    q, k, v = _project_qkv(cfg, lp["attn"], norm_apply(lp["ln1"], e,
                                                       cfg.norm))
    ki, vi, ksc, vsc, _ = _quantize_kv(k, v, features=False)
    o = ops.prefill_attention(
        *_to_rows(*_q(q)), ki, vi, ksc, vsc,
        torch.full((b,), s, dtype=torch.int32, device=e.device),
        causal=False, int8_logits=bool(cfg.int8_logits))
    e = e + qlinear(lp["attn"]["wo"], o.transpose(1, 2).reshape(b, s,
                                                                cfg.q_dim))
    return _mlp(cfg, lp, e)


def encode(cfg, qp, frames):
    """The encoder stack and ``ln_enc``: frames f32 [B, S_enc, D] → the
    encoder memory [B, S_enc, D]."""
    enc = frames.to(torch.float32)
    for i in range(cfg.n_encoder_layers):
        enc = encoder_layer(cfg, layer_slice(qp["enc_layers"], i), enc)
    return norm_apply(qp["ln_enc"], enc, cfg.norm)


def build_cross_cache(cfg, lp, enc, cl) -> dict:
    """Quantize the encoder memory enc [B, S_enc, D] through this layer's
    fused cross K‖V projection (one dispatch) into the cross cache layer
    ``cl`` at [0, S_enc) (in place; rows above stay as they were). →
    ``cl``."""
    b, s, _ = enc.shape
    k, v = qlinear_split(lp["wkv"], enc, (cfg.kv_dim, cfg.kv_dim))
    _write_rows(cl, *_quantize_kv(k.reshape(b, s, cfg.n_kv_heads, cfg.hd),
                                  v.reshape(b, s, cfg.n_kv_heads, cfg.hd)),
                0)
    return cl


def cross_attn_prefill(cfg, lp, h, cl, cross_len, kv_max: int | None = None):
    """Decoder-side cross-attention of a whole prompt over the cross cache
    layer ``cl`` (#3 non-causal, no RoPE). ``kv_max`` trims the view to
    the encoder length's block roundup, so the cost follows the frames,
    not the cross capacity."""
    b, s, _ = h.shape
    m = kv_max or cl["k"].shape[2]
    q = qlinear(lp["wq"], h).reshape(b, s, cfg.n_heads, cfg.hd)
    o = ops.prefill_attention(
        *_to_rows(*_q(q)), cl["k"][:, :, :m], cl["v"][:, :, :m],
        cl["k_scale"][:, :, :m], cl["v_scale"][:, :, :m], cross_len,
        causal=False, int8_logits=bool(cfg.int8_logits))
    return qlinear(lp["wo"], o.transpose(1, 2).reshape(b, s, cfg.q_dim))


def lop_decode_attention(cfg, qi, qsc, cl, new_len, *, window: int,
                         use_lop: bool = True, k_keep: int | None = None,
                         mode: str | None = None):
    """qi int8 [B, H, dh]; qsc f32 [B, H, 1] → f32 [B, H, dh].
    ``k_keep`` overrides the config's kept-block budget (the speculative
    draft's pinched budget); None is the config's policy. ``mode`` is the
    kernel's launch-count mode (``ops.decode_attention``)."""
    cfg = resolve_decode_flags(cfg)
    m = cl["k"].shape[2]
    if k_keep is None:
        k_keep = k_keep_blocks(cfg, m)
    return ops.decode_attention(
        qi, qsc, cl["k"], cl["v"], cl["k_scale"], cl["v_scale"], cl["feat"],
        new_len, block=cfg.lop_block,
        k_keep=max(1, min(k_keep, m // cfg.lop_block)), window=window,
        use_lop=use_lop, shared_select=bool(cfg.gqa_shared_select),
        mode=mode)


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


def shard_cache(cache, sp_axes=("model",)) -> dict:
    """This rank's token shard of a whole (replicated) cache: rows
    ``[rank·M/n, (rank + 1)·M/n)`` of every leaf of the self-attention
    pages (a hybrid model's attention sublayers' too; and of the cross
    pages, each against its own capacity), copied, with the other entries
    (recurrent states) kept whole. A single-process mesh keeps the
    whole cache (its shards are views of it). Each capacity M must cut
    into whole ``lop_block`` blocks a shard."""
    from repro_torch.distributed.partitioning import current_mesh
    mesh = current_mesh()
    if mesh is None:
        raise ValueError("shard_cache needs an active mesh")
    if mesh.local:
        return cache
    n, r = mesh.size(sp_axes), mesh.rank(sp_axes)
    def cut(pages):
        m = pages["k"].shape[3]
        if m % n:
            raise ValueError(f"capacity {m} does not cut into {n} shards")
        m_loc = m // n
        return {key: v[:, :, :, r * m_loc:(r + 1) * m_loc].clone()
                for key, v in pages.items()}
    out = dict(cache)
    for tree in ("layers", "cross"):
        if tree in cache and "k" in cache[tree]:
            out[tree] = cut(cache[tree])
    if "blocks" in cache:
        out["blocks"] = dict(cache["blocks"], attn=cut(cache["blocks"]["attn"]))
    return out


def attn_decode(cfg, lp, h, cl, lengths, *, use_lop=True, active=None,
                k_keep=None, sp_axes=None):
    """One-token self-attention with cache append. h [B, 1, D]. With
    ``sp_axes`` the cache layer is this rank's token shard and the
    attention runs sequence-parallel over those mesh axes."""
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
    if sp_axes:
        from repro_torch.distributed.sp_decode import sp_decode_attention
        out, _ = sp_decode_attention(
            cfg, qi, qsc, ki, vi, ksc, vsc, feat, cl, lengths,
            window=cfg.swa_window, use_lop=use_lop and cfg.use_lop,
            sp_axes=sp_axes, active=active)
    else:
        _write_token(cl, ki, vi, ksc, vsc, feat, lengths, active)
        out = lop_decode_attention(cfg, qi, qsc, cl, new_len,
                                   window=cfg.swa_window,
                                   use_lop=use_lop and cfg.use_lop,
                                   k_keep=k_keep)
    if active is not None:
        out = torch.where(active[:, None, None], out, 0.0)
    return qlinear(lp["wo"], out.reshape(b, 1, cfg.q_dim))


def cross_attn_decode(cfg, lp, h, cl, cross_len, *, use_lop=True,
                      sp_axes=None):
    """One-token cross-attention over the cross cache layer ``cl``: the
    decode kernel (LOP or dense) with ``new_len = cross_len``, no window,
    and no cache write. h [B, 1, D]."""
    b = h.shape[0]
    qi, qsc = _q(qlinear(lp["wq"], h).reshape(b, cfg.n_heads, cfg.hd))
    use_lop = use_lop and cfg.use_lop
    if sp_axes:
        from repro_torch.distributed.sp_decode import sp_decode_attention
        out, _ = sp_decode_attention(
            cfg, qi, qsc, None, None, None, None, None, cl, cross_len,
            window=0, use_lop=use_lop, sp_axes=sp_axes, write=False)
    else:
        out = lop_decode_attention(cfg, qi, qsc, cl, cross_len, window=0,
                                   use_lop=use_lop, mode="cross")
    return qlinear(lp["wo"], out.reshape(b, 1, cfg.q_dim))


def _mlp(cfg, lp, x):
    h = norm_apply(lp["ln2"], x, cfg.norm)
    if "moe" in lp:
        return x + moe_apply(cfg, lp["moe"], h)
    return x + ffn_apply(cfg, lp["ffn"], h)


def _attn_layer(cfg, lp, x, cl, *, lengths=None, cross=None, **decode):
    """One attention layer over x [B, T, D]: self-attention on the page
    layer ``cl`` — the whole prompt at its exact length, or, given
    ``lengths``, one decode token a lane (``decode`` the keywords of
    :func:`attn_decode`) —, then, for an encdec decoder layer, ``cross``
    (a function of the normed x: its cross-attention), then the FFN or
    MoE."""
    h = norm_apply(lp["ln1"], x, cfg.norm)
    if lengths is None:
        x = x + attn_prefill(cfg, lp["attn"], h, cl)
    else:
        x = x + attn_decode(cfg, lp["attn"], h, cl, lengths, **decode)
    if cross is not None:
        x = x + cross(norm_apply(lp["ln_x"], x, cfg.norm))
    return _mlp(cfg, lp, x)


def _write_state(dst: dict, src: dict) -> None:
    """Copy each new state leaf into the cache's own tensor (in place)."""
    for name, val in src.items():
        dst[name].copy_(val)


def _rwkv_layer(cfg, lp, x, st):
    """One rwkv6 layer over x [B, T, D] — a whole prompt from the zero
    states of a fresh cache, or one decode token — from the state views
    ``st`` (``wkv``, ``x_tm``, ``x_cm``), which are rewritten with the
    state after the last token."""
    h = norm_apply(lp["ln1"], x, cfg.norm)
    y, x_tm, wkv = rwkv6.rwkv_time_mix(cfg, lp["tm"], h, st["x_tm"],
                                       st["wkv"])
    x = x + y
    h = norm_apply(lp["ln2"], x, cfg.norm)
    y, x_cm = rwkv6.rwkv_channel_mix(cfg, lp["tm"], h, st["x_cm"])
    _write_state(st, {"wkv": wkv, "x_tm": x_tm, "x_cm": x_cm})
    return x + y


def _mamba_layer(cfg, lp, x, st, *, prefill: bool):
    """One Mamba sublayer and its FFN or MoE: the whole prompt from zero
    states (``prefill``) or one decode token from the state views ``st``
    (``ssm``, ``conv``), which are rewritten with the new state."""
    h = norm_apply(lp["ln1"], x, cfg.norm)
    if prefill:
        y, new = mamba_forward(cfg, lp["mamba"], h)
    else:
        y, new = mamba_decode_step(cfg, lp["mamba"], h, st)
    _write_state(st, new)
    return _mlp(cfg, lp, x + y)


def _hybrid_sublayers(cfg, qp, cache):
    """A hybrid model's sublayers in order: (weights, the superblock's
    page layer, None) for the attention sublayer, (weights, None, its
    state views) for a Mamba one."""
    for sb in range(cfg.n_layers // cfg.attn_every):
        bp = layer_slice(qp["blocks"], sb)
        bc = layer_slice(cache["blocks"], sb)
        mi = 0
        for j in range(cfg.attn_every):
            if cfg.is_attn_layer(j):
                yield bp[f"sub{j}"], bc["attn"], None
            else:
                yield bp[f"sub{j}"], None, layer_slice(bc["mamba"], mi)
                mi += 1


def _embed(cfg, qp, tokens, patches=None):
    """Token embeddings [B, T, D], behind (vlm) the image prefix: patches
    f32 [B, n_img, D] through the f32 projector, a plain product outside
    any kernel (TF32 is off on the card), as the reference's ``_embed``.
    → [B, n_img + T, D]."""
    x = embedding_apply(qp["embed"], tokens)
    if patches is None:
        return x
    if cfg.family != "vlm":
        raise ValueError(f"family {cfg.family!r} takes no patches")
    return torch.cat([patches.to(x.dtype) @ qp["projector"]["w"], x], dim=1)


def _logits(cfg, qp, x_last):
    return head_apply(qp["head"], norm_apply(qp["ln_f"], x_last, cfg.norm))


def _recurrent_stack(cfg, qp, cache, x, *, lengths=None, **decode):
    """The layers of an ssm or hybrid model over x [B, T, D]: a whole
    prompt from the fresh cache's zero states and empty pages, or, given
    ``lengths``, one decode token a lane (``decode`` the attention
    sublayers' keywords of :func:`attn_decode`)."""
    if cfg.family == "ssm":
        for i in range(cfg.n_layers):
            x = _rwkv_layer(cfg, layer_slice(qp["layers"], i), x,
                            layer_slice(cache["layers"], i))
        return x
    for lp, cl, st in _hybrid_sublayers(cfg, qp, cache):
        if st is None:
            x = _attn_layer(cfg, lp, x, cl, lengths=lengths, **decode)
        else:
            x = _mamba_layer(cfg, lp, x, st, prefill=lengths is None)
    return x


def prefill(cfg, qp, tokens, *, max_len=None, frames=None, patches=None):
    """Whole-prompt forward writing a new batch-B cache.

    tokens int [B, S] on the weights' device; ``frames`` f32 [B, S_enc, D]
    the encoder input of an encdec model (required there, refused
    elsewhere); ``patches`` f32 [B, n_img, D] a vlm request's image prefix
    (optional there, refused elsewhere), which makes the stream S' = n_img
    + S long. → (logits [B, V] at the last position, cache with capacity
    for ``max(max_len, S')`` tokens and, encdec, cross pages of capacity
    ``round_up(max(cross_ctx, S_enc), lop_block)`` holding the encoder
    memory at [0, S_enc), ``cross_len = S_enc``; ssm and hybrid, each
    layer's recurrent state after the prompt, from zero states).
    """
    cfg = resolve_decode_flags(cfg)
    _check_family(cfg)
    encdec = cfg.family == "encdec"
    if encdec != (frames is not None):
        raise ValueError(f"family {cfg.family!r} "
                         + ("needs" if encdec else "takes no") + " frames")
    x = _embed(cfg, qp, tokens, patches)
    b, s, _ = x.shape
    max_len = max(max_len if max_len is not None else 0, s)
    s_enc = frames.shape[1] if encdec else 0
    cache = init_cache(cfg, b, max_len, tokens.device, frames=s_enc)
    if encdec:
        enc = encode(cfg, qp, frames)
        cache["cross_len"].fill_(s_enc)
        kv_max = round_up(s_enc, cfg.lop_block)
    if cfg.family in ("ssm", "hybrid"):
        x = _recurrent_stack(cfg, qp, cache, x)
        cache["lengths"].fill_(s)
        return _logits(cfg, qp, x[:, -1]), cache
    for i in range(cfg.n_layers):
        lp = layer_slice(qp["layers"], i)
        cross = None
        if encdec:
            def cross(h, lp=lp, i=i):
                xcl = build_cross_cache(cfg, lp["xattn"], enc,
                                        layer_slice(cache["cross"], i))
                return cross_attn_prefill(cfg, lp["xattn"], h, xcl,
                                          cache["cross_len"], kv_max=kv_max)
        x = _attn_layer(cfg, lp, x, layer_slice(cache["layers"], i),
                        cross=cross)
    cache["lengths"].fill_(s)
    return _logits(cfg, qp, x[:, -1]), cache


def prefill_chunk(cfg, qp, tokens, cache, *, start: int, seq_end: int,
                  patches=None, all_logits: bool = False):
    """One chunk of chunked prefill. tokens [B, C] at positions
    [start, start + C); ``cache`` holds [0, start) and is written in place
    at [start, start + C) with ``lengths = seq_end``. → (logits [B, V] at
    position ``seq_end - 1``, cache).

    A vlm stream is [image prefix ‖ text]: a lane's first chunk carries
    ``patches`` f32 [B, n_img, D] too, so its embedded width is C' = n_img
    + C at ``start`` 0, it writes [0, C') and its logits row is
    ``clip(seq_end - 1 - start, 0, C' - 1)``; later chunks start past the
    prefix.

    ``start`` may be any block multiple on a lane's first chunk: a prefix
    hit resumes past cloned pages with the same carry as any later chunk.
    With ``all_logits=True`` the logits are [B, C, V], one row a chunk
    position — the speculative verify call, whose row i is the target for
    the token after position ``start + i``."""
    cfg = resolve_decode_flags(cfg)
    # the chunk carry needs routing that does not see other tokens: moe
    # routers rank a group's tokens for capacity, so moe never chunks
    _check_family(cfg, CHUNKED_FAMILIES, "chunked prefill")
    x = _embed(cfg, qp, tokens, patches)
    b, c, _ = x.shape
    kv_len = torch.full((b,), start + c, dtype=torch.int32,
                        device=tokens.device)
    for i in range(cfg.n_layers):
        lp = layer_slice(qp["layers"], i)
        cl = layer_slice(cache["layers"], i)
        x = x + attn_prefill_chunk(cfg, lp["attn"],
                                   norm_apply(lp["ln1"], x, cfg.norm), cl,
                                   start=start, kv_len=kv_len)
        x = _mlp(cfg, lp, x)
    cache["lengths"].fill_(seq_end)
    if all_logits:
        return _logits(cfg, qp, x), cache
    idx = min(max(seq_end - 1 - start, 0), c - 1)
    return _logits(cfg, qp, x[:, idx]), cache


def serve_step(cfg, qp, cache, tokens, *, use_lop=True, active=None,
               n_layers: int | None = None, k_keep: int | None = None,
               sp_axes=None):
    """One decode step. tokens [B, 1] → (logits [B, V], cache).

    Only the lanes of ``active`` (bool [B]; by default the pool's own
    ``"active"`` mask, and every lane of a cache without one) decode: the
    others write nothing and keep their lengths. The cache is updated in
    place and no entry of it is rebound, so a CUDA graph of the step stays
    valid for the same cache.

    The self-speculative draft step is the same step cut short: the first
    ``n_layers`` decoder layers (views of the pool's layer axis) with the
    LOP budget pinched to ``k_keep`` kept blocks, then the shared head. Its
    rows land in those layers only and ``lengths`` moves as in a full
    step: provisional state that the verify chunk overwrites for every
    layer and ``rollback_slot`` rewinds for rejected tokens.

    With ``sp_axes`` (under an active mesh) the cache holds this rank's
    token shard (:func:`shard_cache`) and every layer's attention runs
    sequence-parallel; ``lengths`` stay global. It runs eagerly.

    An encdec decoder layer attends its cross pages after its
    self-attention (:func:`cross_attn_decode`): read only, over
    ``cross_len`` keys, for every lane (as in the reference, an inactive
    lane's result is never read).

    An ssm or hybrid model steps every lane's recurrent state, active or
    not, as the reference's bodies do; a hybrid model's attention pages
    follow ``active``. Under ``sp_axes`` a hybrid model's attention
    sublayers run sequence-parallel over their sharded pages while every
    rank steps the whole Mamba state; an ssm model has no pages and
    ignores ``sp_axes``, as the reference's body does.
    """
    cfg = resolve_decode_flags(cfg)
    _check_family(cfg)
    if n_layers is not None:
        _check_family(cfg, CHUNKED_FAMILIES, "the speculative draft")
    lengths = cache["lengths"]
    if active is None:
        active = cache.get("active")
    x = embedding_apply(qp["embed"], tokens)
    if cfg.family in ("ssm", "hybrid"):
        x = _recurrent_stack(cfg, qp, cache, x, lengths=lengths,
                             use_lop=use_lop, active=active,
                             sp_axes=sp_axes)
        lengths.add_(1 if active is None else active.to(torch.int32))
        return _logits(cfg, qp, x[:, -1]), cache
    for i in range(cfg.n_layers if n_layers is None else n_layers):
        lp = layer_slice(qp["layers"], i)
        cross = None
        if "xattn" in lp:
            def cross(h, lp=lp, i=i):
                return cross_attn_decode(
                    cfg, lp["xattn"], h, layer_slice(cache["cross"], i),
                    cache["cross_len"], use_lop=use_lop, sp_axes=sp_axes)
        x = _attn_layer(cfg, lp, x, layer_slice(cache["layers"], i),
                        lengths=lengths, cross=cross, use_lop=use_lop,
                        active=active, k_keep=k_keep, sp_axes=sp_axes)
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
