"""Token-choice top-k Mixture-of-Experts, serving path (the reference's
``moe_apply`` / ``_dispatch_group`` over a fused expert-stacked node).

Tokens go in groups of ``moe_group`` (the tail group padded with zero
rows). In a group of T tokens each token's router picks its top-k experts,
and every expert takes at most ``cap`` tokens, in token-major then
choice-rank order; later choices past ``cap`` are dropped. The kept rows
gather into xe [E, cap, d] (empty slots all zero), run through ONE
grouped-expert FFN launch (#2 with the expert as a grid axis), and each
token sums its kept experts' rows weighted by its normalized gates.

Numerics, against the reference and within the port:

  * the router product and softmax are taken in float64 and rounded once
    to f32 (logits, then probabilities), and the gate sum in float64 too,
    so a token's gates do not depend on how many tokens share the call
    (cuBLAS picks another reduction at T = 1 and T = 4); they differ from
    XLA's f32 by ulps;
  * the choices, capacity positions and keep mask are integers, bitwise
    the reference's for equal probabilities. ``torch.topk`` promises no
    order among equal values where ``jax.lax.top_k`` takes the lower
    index first. Exact ties happen on the zero pad rows (all logits 0),
    whose outputs are discarded, and those rows come last in the
    token-major order, so they never take capacity from a real token;
  * dispatch and combine gather by index, and a token's output is a sum
    over its k choices in an order fixed by k alone (pairwise halves), so
    it does not depend on the batch either. Decode groups are drop-free (``cap``
    ≥ min(T, 8)), so with up to 8 lanes a lane's tokens do not depend on
    the other lanes.

Everything is static-shaped with no host sync (no ``.item()``, no
``nonzero``, no boolean-mask indexing), so a decode step that runs it is
captured whole in a CUDA graph. The load-balancing aux loss is not
computed there: serving never reads it.

Training (:func:`train_moe_apply`, the reference's ``moe_apply`` on f32
master expert stacks) routes in f32 as the reference does, picks the top
k by a stable descending sort (equal probabilities in index order, as
``jax.lax.top_k``), dispatches and combines by differentiable gathers
(the values of the reference's one-hot einsums, without their [T, E,
cap] tensors), runs the experts as plain products of STE-ternary weights
in the activation dtype, and returns the Switch load-balancing loss.
"""

from __future__ import annotations

import torch

from repro_torch.core.qlinear import ffn_node_apply
from repro_torch.core.ternary import ste_ternary
from repro_torch.models.layers import gelu, silu


def capacity(cfg, t: int) -> int:
    """Slots an expert has in a group of ``t`` tokens — the reference's
    Python float arithmetic; the floor min(t, 8) keeps decode groups
    drop-free."""
    e, k = cfg.n_experts, cfg.top_k
    return int(max(-(-t * k * cfg.capacity_factor // e), k, min(t, 8)))


def route(cfg, router: torch.Tensor, x: torch.Tensor):
    """One group's routing. x f32 [T, d]; router f32 [d, E] →
    (gates f32 [T, k], expert int64 [T, k], pos int64 [T, k], keep bool
    [T, k], cap): the normalized gate of each choice, its expert, its
    position in that expert's capacity bucket, and whether it fits."""
    t = x.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(cfg, t)
    logits = (x.to(torch.float64) @ router.to(torch.float64)).to(
        torch.float32)
    probs = torch.softmax(logits.to(torch.float64), dim=-1).to(torch.float32)
    vals, expert = torch.topk(probs, k, dim=-1)               # descending
    denom = vals.to(torch.float64).sum(-1, keepdim=True).to(torch.float32)
    # divide by a tensor: ``t / scalar`` on CUDA multiplies by 1/scalar
    gates = vals / torch.clamp_min(denom, 1e-9)
    pos, keep, _ = _positions(expert, e, cap)
    return gates, expert, pos, keep, cap


def _positions(expert: torch.Tensor, e: int, cap: int):
    """expert int64 [T, k] → (pos [T, k]: each (token, choice)'s position
    among its expert's earlier picks, keep [T, k]: pos < cap, onehot int32
    [T, k, E])."""
    t, k = expert.shape
    onehot = (expert[..., None] == torch.arange(e, device=expert.device)
              ).to(torch.int32)
    flat = onehot.reshape(t * k, e)
    before = (torch.cumsum(flat, dim=0) - flat).reshape(t, k, e)
    pos = (before * onehot).sum(-1)
    return pos, pos < cap, onehot


def _gather_experts(x: torch.Tensor, expert, pos, keep, cap: int, e: int):
    """x [T, d] → (xe [E, cap, d]: each kept choice's token row at its
    expert's capacity slot, empty slots zero; slot [T, k])."""
    t, d = x.shape
    slot = expert * cap + pos                                 # [T, k]
    # which token fills each capacity slot: token t for a kept choice,
    # the zero row T for an empty slot; dropped choices all write the
    # trash slot e·cap, which is never read
    token = torch.arange(t, device=x.device)[:, None].expand_as(slot)
    filler = torch.full((e * cap + 1,), t, dtype=torch.int64,
                        device=x.device)
    filler.scatter_(0, torch.where(keep, slot, e * cap).reshape(-1),
                    token.reshape(-1))
    rows = torch.cat([x, x.new_zeros((1, d))])
    return rows[filler[:e * cap]].reshape(e, cap, d), slot


def _kept_terms(ye: torch.Tensor, slot, keep, gates) -> torch.Tensor:
    """Each choice's expert row [E, cap, d] weighted by its f32 gate →
    [T, k, d] f32; a dropped choice adds exact zero, whatever its slot-0
    stand-in holds."""
    rows = ye.reshape(-1, ye.shape[-1])[torch.where(keep, slot, 0)]
    return torch.where(keep[..., None],
                       rows.to(torch.float32) * gates[..., None], 0.0)


def dispatch_group(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    """One token group x f32 [T, d] → the MoE output f32 [T, d]."""
    gates, expert, pos, keep, cap = route(cfg, p["router"], x)
    xe, slot = _gather_experts(x.to(torch.float32), expert, pos, keep, cap,
                               cfg.n_experts)
    ye = ffn_node_apply(p, xe, gated=cfg.gated_ffn,
                        act="silu" if cfg.gated_ffn else "gelu")
    # the choices summed in an order fixed by k alone
    return _sum_choices(_kept_terms(ye, slot, keep, gates))


def _sum_choices(terms: torch.Tensor) -> torch.Tensor:
    """[T, k, d] → [T, d]: pairwise halves (choices j and j + k/2, an odd
    last choice carried), elementwise adds in an order fixed by k alone,
    so a token's sum does not depend on T."""
    while terms.shape[1] > 1:
        n = terms.shape[1]
        h = n // 2
        pairs = terms[:, :h] + terms[:, h:2 * h]
        terms = torch.cat([pairs, terms[:, 2 * h:]], 1) if n % 2 else pairs
    return terms[:, 0]


def moe_apply(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    """x [B, S, d] → [B, S, d]: groups of ``moe_group`` tokens in order,
    the last padded with zero rows, each dispatched on its own."""
    b, s, d = x.shape
    flat = x.reshape(b * s, d)
    t = flat.shape[0]
    grp = max(1, min(cfg.moe_group, t))
    pad = -t % grp
    if pad:
        flat = torch.cat([flat, flat.new_zeros((pad, d))])
    out = torch.cat([dispatch_group(cfg, p, flat[i:i + grp])
                     for i in range(0, t + pad, grp)])
    return out[:t].reshape(b, s, d)


# ---------------------------------------------------------------------------
# training: f32 master expert stacks, the Switch aux loss
# ---------------------------------------------------------------------------

def _prepare_expert_weights(cfg, p: dict, act_dtype) -> dict:
    """Once a layer: each expert stack through the STE (one γ over the
    whole stack, as the reference reshapes it to [E·k, n]), cast to the
    activation dtype."""
    out = dict(p)
    for name in ("w_gate", "w_up", "w_down"):
        if name not in p:
            continue
        w = p[name]
        if cfg.quant == "ternary":
            w = ste_ternary(w.reshape(-1, w.shape[-1])).reshape(w.shape)
        out[name] = w.to(act_dtype)
    return out


def route_f32(router: torch.Tensor, x: torch.Tensor, k: int):
    """The reference's f32 routing of x [T, d] → (probs f32 [T, E], the
    normalized gates f32 [T, k], expert int64 [T, k]): the top k by a
    stable descending sort (equal probabilities in index order, as
    ``jax.lax.top_k``), each gate over max(Σ gates, 1e-9)."""
    probs = torch.softmax(x.to(torch.float32) @ router, dim=-1)
    vals, expert = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, expert = vals[:, :k], expert[:, :k]
    return probs, vals / torch.clamp_min(vals.sum(-1, keepdim=True),
                                         1e-9), expert


def _train_dispatch_group(cfg, p: dict, x: torch.Tensor):
    """One token group x [T, d] → (the MoE output [T, d] in x's dtype,
    the group's aux loss f32): the reference's ``_dispatch_group`` on
    prepared training weights."""
    t = x.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(cfg, t)
    probs, gates, expert = route_f32(p["router"], x, k)
    pos, keep, onehot = _positions(expert, e, cap)
    xe, slot = _gather_experts(x, expert, pos, keep, cap, e)
    if cfg.gated_ffn:
        h = silu(torch.matmul(xe, p["w_gate"])) * torch.matmul(xe, p["w_up"])
    else:
        h = gelu(torch.matmul(xe, p["w_up"]))
    ye = torch.matmul(h, p["w_down"])
    y = _kept_terms(ye, slot, keep, gates).sum(1)
    frac_tokens = onehot.sum(1).to(torch.float32).mean(0)
    aux = e * torch.sum(frac_tokens / k * probs.mean(0))
    return y.to(x.dtype), aux


def train_moe_apply(cfg, p: dict, x: torch.Tensor):
    """x [B, S, d] → ([B, S, d], aux): the training MoE over groups of
    ``moe_group`` tokens (the last padded with zero rows, which come last
    in their group and so take no capacity from a real token), aux the
    mean over groups."""
    b, s, d = x.shape
    p = _prepare_expert_weights(cfg, p, x.dtype)
    flat = x.reshape(b * s, d)
    t = flat.shape[0]
    grp = max(1, min(cfg.moe_group, t))
    pad = -t % grp
    if pad:
        flat = torch.cat([flat, flat.new_zeros((pad, d))])
    ys, auxs = zip(*(_train_dispatch_group(cfg, p, flat[i:i + grp])
                     for i in range(0, t + pad, grp)))
    return (torch.cat(ys)[:t].reshape(b, s, d),
            torch.stack(auxs).mean())
