"""Dense decoder parameters, drawn from an explicit ``torch.Generator``.

The tree mirrors the reference's ``init_params`` for the dense family:
``embed.table``, ``ln_f.g``, ``head.w`` and layer-stacked ``layers`` with
``ln1``, ``attn.{wq,wk,wv,wo}``, ``ln2`` and ``ffn.{w_gate,w_up,w_down}``
(the reference uses ``jax.random`` — the same seed gives other numbers, so
tests carry the reference's weights over with :mod:`repro_torch.convert`).
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


def init_params(cfg, seed: int, device="cpu") -> dict:
    """Full f32 master tree of a dense model: embed, head, then the layers
    in order, all drawn from one generator seeded with ``seed``."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d, f, vp = cfg.d_model, cfg.d_ff, cfg.vocab_padded
    params = {"embed": {"table": torch.randn((vp, d), generator=gen,
                                             device=device) * 0.02},
              "ln_f": {"g": torch.ones(d, device=device)},
              "head": linear_init(gen, d, vp, device=device)}
    layers = []
    for _ in range(cfg.n_layers):
        attn = {"wq": linear_init(gen, d, cfg.q_dim, device=device),
                "wk": linear_init(gen, d, cfg.kv_dim, device=device),
                "wv": linear_init(gen, d, cfg.kv_dim, device=device),
                "wo": linear_init(gen, cfg.q_dim, d, device=device)}
        ffn = {"w_gate": linear_init(gen, d, f, device=device),
               "w_up": linear_init(gen, d, f, device=device),
               "w_down": linear_init(gen, f, d, device=device)}
        layers.append({"ln1": {"g": torch.ones(d, device=device)},
                       "attn": attn,
                       "ln2": {"g": torch.ones(d, device=device)},
                       "ffn": ffn})
    params["layers"] = stack_trees(layers)
    return params
