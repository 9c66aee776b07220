"""Decoder parameters (dense and moe families), drawn from an explicit
``torch.Generator``.

The tree mirrors the reference's ``init_params``: ``embed.table``,
``ln_f.g``, ``head.w`` and layer-stacked ``layers`` with ``ln1``,
``attn.{wq,wk,wv,wo}``, ``ln2`` and either ``ffn.{w_gate,w_up,w_down}``
(dense) or ``moe`` (the reference's ``moe_init``: ``router`` [d, E] and
the expert stacks ``w_gate``/``w_up`` [E, d, f] and ``w_down`` [E, f, d]
as raw tensors). The reference uses ``jax.random`` — the same seed gives
other numbers, so tests carry the reference's weights over with
:mod:`repro_torch.convert`.
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import linear_init


def stack_trees(trees: list) -> dict:
    """List of identically-shaped trees → one tree with a leading axis."""
    if isinstance(trees[0], dict):
        return {k: stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def layer_slice(tree, i: int):
    """Layer ``i`` of a layer-stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def moe_init(gen: torch.Generator, cfg, *, device) -> dict:
    """One MoE layer's f32 master weights: the router [d, E] and the
    expert stacks, each scaled by its fan-in^-0.5."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts

    def draw(*shape, fan_in):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32) * (fan_in ** -0.5)
    return {"router": draw(d, e, fan_in=d),
            "w_gate": draw(e, d, f, fan_in=d),
            "w_up": draw(e, d, f, fan_in=d),
            "w_down": draw(e, f, d, fan_in=f)}


def init_params(cfg, seed: int, device="cpu") -> dict:
    """Full f32 master tree of a dense or moe model: embed, head, then the
    layers in order, all drawn from one generator seeded with ``seed``."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d, f, vp = cfg.d_model, cfg.d_ff, cfg.vocab_padded
    params = {"embed": {"table": torch.randn((vp, d), generator=gen,
                                             device=device) * 0.02},
              "ln_f": {"g": torch.ones(d, device=device)},
              "head": linear_init(gen, d, vp, device=device)}
    layers = []
    for i in range(cfg.n_layers):
        attn = {"wq": linear_init(gen, d, cfg.q_dim, device=device),
                "wk": linear_init(gen, d, cfg.kv_dim, device=device),
                "wv": linear_init(gen, d, cfg.kv_dim, device=device),
                "wo": linear_init(gen, cfg.q_dim, d, device=device)}
        layer = {"ln1": {"g": torch.ones(d, device=device)}, "attn": attn,
                 "ln2": {"g": torch.ones(d, device=device)}}
        if cfg.is_moe_layer(i):
            layer["moe"] = moe_init(gen, cfg, device=device)
        else:
            layer["ffn"] = {"w_gate": linear_init(gen, d, f, device=device),
                            "w_up": linear_init(gen, d, f, device=device),
                            "w_down": linear_init(gen, f, d, device=device)}
        layers.append(layer)
    params["layers"] = stack_trees(layers)
    return params
