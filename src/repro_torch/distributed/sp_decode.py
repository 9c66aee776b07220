"""Sequence-parallel decode attention — the counterpart of the reference's
``distributed/sp_decode.py``.

The K/V/feature cache's token axis is cut into ``n`` shards of ``M/n``
rows over the mesh axes ``sp_axes``. For one decode step each shard:

  1. writes the new token if it owns position ``lengths[b]`` (retired
     lanes never write);
  2. runs the same fused decode kernel as the local path
     (:func:`repro_torch.kernels.ops.decode_attention`) over its rows with
     ``pos_offset = rank · M/n``, so validity, the window and each
     candidate's live interval land on global positions, and a quota of
     ⌈K/n⌉ candidate blocks (``k_keep`` of the global capacity), taking
     back the unnormalized softmax stats (m, ℓ);
  3. merges flash-decoding style: m_g = pmax(m), w = exp(m − m_g), ℓ_g =
     psum(ℓ·w), out = psum(out·ℓ·w) / max(ℓ_g, 1e-20). An empty shard
     (m = −1e30, ℓ = 0) weighs nothing.

Quota selection is not a global top-K: n·⌈K/n⌉ candidates, each shard's
best. With ``lop_keep = 1`` every live block is taken and the result is
exact attention up to rounding.

Over a process group each rank holds its own shard ``[B, Hkv, M/n, ...]``
and the collectives are ``all_reduce``s; over a single-process mesh the
cache is whole and the shards are its views, walked in rank order, and
the merge reduces their stacked stats.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import resolve_decode_flags
from repro_torch.distributed.partitioning import current_mesh, pmax, psum
from repro_torch.kernels import ops
from repro_torch.serving.lop_select import k_keep_blocks

_KEYS = ("k", "v", "k_scale", "v_scale", "feat")


def _write_token_local(cl, ki, vi, ksc, vsc, feat, lengths, offset: int,
                       m_loc: int, active=None) -> None:
    """Masked cache append on one shard (in place): a lane writes where its
    position ``lengths[b]`` falls in ``[offset, offset + m_loc)`` and it is
    active; the other lanes write their old row back."""
    local = lengths.to(torch.int64) - offset
    ok = (local >= 0) & (local < m_loc)
    if active is not None:
        ok = ok & active
    pos = local.clamp(0, m_loc - 1)
    lanes = torch.arange(lengths.shape[0], device=lengths.device)
    for key, val in (("k", ki), ("v", vi), ("k_scale", ksc[..., 0]),
                     ("v_scale", vsc[..., 0]), ("feat", feat)):
        keep = ok.reshape(-1, *([1] * (val.dim() - 1)))
        cl[key][lanes, :, pos] = torch.where(keep, val, cl[key][lanes, :, pos])


def sp_decode_attention(cfg, qi, qsc, ki, vi, ksc, vsc, feat, cl, lengths, *,
                        window: int, use_lop: bool, sp_axes: tuple,
                        write: bool = True, active=None):
    """SP decode attention over a token-sharded cache layer.

    qi int8 [B, H, dh]; qsc f32 [B, H, 1]; ki/vi int8 [B, Hkv, dh] and
    ksc/vsc f32 [B, Hkv, 1] and feat uint8 [B, Hkv, dh/2] (the new token;
    None with ``write=False``, cross-attention); ``cl`` this rank's shard
    of a cache layer (the whole layer on a single-process mesh), written
    in place; lengths int32 [B] global; active bool [B] (None = all).
    → (out f32 [B, H, dh], cl).
    """
    mesh = current_mesh()
    if mesh is None:
        raise ValueError("sp decode needs an active mesh")
    cfg = resolve_decode_flags(cfg)
    b, h, dh = qi.shape
    if active is None:
        active = torch.ones((b,), dtype=torch.bool, device=qi.device)
    n = mesh.size(sp_axes)
    rows = cl["k"].shape[2]
    m_global = rows if mesh.local else rows * n
    m_loc = m_global // n
    block = cfg.lop_block
    if m_loc * n != m_global or m_loc % block:
        raise ValueError(f"capacity {m_global} does not cut into {n} shards "
                         f"of whole {block}-token blocks")
    k_keep = max(1, -(-k_keep_blocks(cfg, m_global) // n))       # quota
    new_len = lengths + (1 if write else 0)
    # retired lanes see an empty cache (nothing to screen or select)
    new_len = torch.where(active, new_len, 0).to(torch.int32)
    ranks = range(n) if mesh.local else (mesh.rank(sp_axes),)
    parts = []
    for r in ranks:
        offset = r * m_loc
        part = cl if not mesh.local else {
            key: cl[key][:, :, offset:offset + m_loc] for key in _KEYS}
        if write:
            _write_token_local(part, ki, vi, ksc, vsc, feat, lengths, offset,
                               m_loc, active=active)
        parts.append(ops.decode_attention(
            qi, qsc, part["k"], part["v"], part["k_scale"], part["v_scale"],
            part["feat"], new_len, block=block, k_keep=k_keep, window=window,
            use_lop=use_lop, shared_select=bool(cfg.gqa_shared_select),
            pos_offset=offset, return_stats=True))
    if mesh.local:
        out, m, l = (torch.stack(t) for t in zip(*parts))
    else:
        out, m, l = parts[0]
    # flash-decoding merge (out·ℓ recovers each shard's raw accumulator)
    m_g = pmax(m, sp_axes, mesh)
    w = torch.exp(m - m_g)
    l_g = psum(l * w, sp_axes, mesh)
    acc = psum(out * (l * w), sp_axes, mesh)
    out = acc / torch.clamp_min(l_g, 1e-20)
    return out.reshape(b, h, dh), cl
