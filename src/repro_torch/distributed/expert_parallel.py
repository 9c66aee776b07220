"""Expert parallelism: all-to-all token dispatch — the counterpart of the
reference's ``distributed/expert_parallel.py``.

When ``n_experts`` divides the expert axis, each rank of that axis owns
E/n experts (a contiguous block). A rank routes its own tokens, with the
capacity of its own token count, sends each expert's capacity bucket to
the expert's owner with an all-to-all over the expert axis alone, runs
its experts on what arrives, sends the rows back with a second
all-to-all, and combines them with its gates — the Switch/GShard
schedule, in the reference's ``all_to_all(tiled=False)`` layout. The
router and dispatch are the training MoE's (f32 routing, the reference's
top-k and 1e-9 floor; :mod:`repro_torch.models.moe`); the capacity is the
reference EP body's own, ``int(max(T·k/E·capacity_factor, k))``, and the
experts run their weights as given (no STE), as there.

Every rank of a data slice holds the same tokens (the batch is cut over
``token_axes`` only), so each expert owner runs every model rank's copy
of them, as the reference's ``shard_map`` does; the rows are gathered
over ``token_axes`` at the end, so every rank returns the whole batch's.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.partitioning import (Mesh, all_gather,
                                                  all_to_all, current_mesh,
                                                  each_shard, shard_of)
from repro_torch.models.layers import gelu, silu
from repro_torch.models.moe import (_gather_experts, _kept_terms, _positions,
                                    route_f32)


def _dispatch(cfg, router, x_loc, n_ep: int):
    """One rank's routing of x_loc [b, s, d] → (send [n_ep, e_loc, cap,
    d]: expert block j's buckets for rank j, and what the combine needs)."""
    b, s, d = x_loc.shape
    t, e, k = b * s, cfg.n_experts, cfg.top_k
    flat = x_loc.reshape(t, d)
    cap = int(max(t * k / e * cfg.capacity_factor, k))
    _, gates, expert = route_f32(router, flat, k)
    pos, keep, _ = _positions(expert, e, cap)
    xe, slot = _gather_experts(flat, expert, pos, keep, cap, e)
    return xe.reshape(n_ep, e // n_ep, cap, d), (slot, keep, gates, cap)


def _experts(cfg, p: dict, r: int, e_loc: int, got: torch.Tensor):
    """Rank ``r``'s experts on what arrived, [e_loc, cap, n_src, d] → the
    rows to send back, [n_ep, e_loc, cap, d]."""
    e_loc, cap, n_src, d = got.shape
    xe = got.transpose(1, 2).reshape(e_loc, n_src * cap, d).contiguous()

    def ffn(name, h):
        return torch.matmul(h, p[name][r * e_loc:(r + 1) * e_loc]
                            .to(h.dtype))
    if cfg.gated_ffn:
        h = silu(ffn("w_gate", xe)) * ffn("w_up", xe)
    else:
        h = gelu(ffn("w_up", xe))
    ye = ffn("w_down", h)
    return ye.reshape(e_loc, n_src, cap, d).transpose(0, 1).contiguous()


def _combine(back: torch.Tensor, route, shape, dtype):
    """[e_loc, cap, n_src, d] from the expert owners → y [b, s, d]."""
    slot, keep, gates, cap = route
    e_loc, _, n_src, d = back.shape
    ye = back.permute(2, 0, 1, 3).reshape(n_src * e_loc, cap, d)
    return _kept_terms(ye, slot, keep, gates).sum(1).reshape(shape).to(
        dtype)


def ep_moe_apply(cfg, p: dict, x: torch.Tensor, mesh: Mesh | None = None,
                 *, axis: str = "model", token_axes=("data",)):
    """MoE with expert-parallel all-to-all over ``mesh[axis]``: x [B, S,
    d], the whole batch, cut over ``token_axes``; → y [B, S, d].

    ``p`` is the whole MoE layer (``router`` [d, E] and the expert stacks
    [E, …]); a rank runs the block of E/n experts it owns. On a
    single-process mesh the result carries the mesh's axes as leading
    dims (size 1 along ``token_axes``): every rank's y."""
    mesh = mesh or current_mesh()
    n_ep = mesh.size(axis)
    e = cfg.n_experts
    if e % n_ep:
        raise ValueError(f"{e} experts do not divide the {axis!r} axis of "
                         f"{n_ep}")
    e_loc = e // n_ep
    cut = (mesh.ordered(token_axes),)
    x_loc = each_shard(lambda c: shard_of(x, cut, c, mesh), mesh)
    send, route = each_shard(
        lambda c, xs: _dispatch(cfg, p["router"], xs, n_ep), mesh, x_loc)
    got = all_to_all(send, axis, 0, 2, mesh)
    out = each_shard(lambda c, g: _experts(cfg, p, c[axis], e_loc, g),
                     mesh, got)
    back = all_to_all(out, axis, 0, 2, mesh)
    y = each_shard(lambda c, bk, rt: _combine(bk, rt, x_loc.shape[-3:],
                                              x.dtype), mesh, back, route)
    return all_gather(y, token_axes, 0, mesh)
