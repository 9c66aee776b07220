"""Master weights → the serving (deployment) format, dense and moe
families.

Every projection becomes packed 2-bit ternary codes plus its absmean γ,
and projection groups fuse into one packed stream each, as the reference's
``quantize_params(fuse=True)`` does:

  * ``attn.{wq,wk,wv,wo}`` → ``attn.wqkv`` (codes concatenated along the
    output axis, a per-column γ row so each column keeps its own
    projection's scalar γ) and ``attn.wo`` (scalar γ, shape [1, 1]);
  * ``ffn.{w_gate,w_up,w_down}`` → ``gu_packed``/``gu_scale`` (gate ‖ up,
    per-column γ row) and ``down_packed``/``down_scale``;
  * ``moe.{w_gate,w_up,w_down}`` expert stacks [E, k, n] fuse the same way
    with a leading expert axis and one γ per expert and stream
    (``gu_scale`` [E, 1, 2f], ``down_scale`` [E, 1, 1]), so a layer's
    expert FFNs are one dispatch; ``moe.router`` stays f32.

Embedding, norms, head and router stay f32. Layer-stacked trees keep their
leading layer axis.
"""

from __future__ import annotations

import torch

from repro_torch.core.ternary import pack_ternary, ternary_quantize
from repro_torch.models.transformer import stack_trees


def _quantize_linear(w: torch.Tensor) -> dict:
    """w f32 [..., k, n] → {"packed": uint8 [..., k//4, n], "scale": f32
    [..., 1, 1]}: one γ per [k, n] matrix (per expert of a stack)."""
    *lead, k, n = w.shape
    packed, scale = [], []
    for wi in w.reshape(-1, k, n):
        wt, gamma = ternary_quantize(wi)
        packed.append(pack_ternary(wt))
        scale.append(gamma.reshape(1, 1))
    return {"packed": torch.stack(packed).reshape(*lead, k // 4, n),
            "scale": torch.stack(scale).reshape(*lead, 1, 1)}


def _concat_packed(parts: list) -> dict:
    """Per-projection packed nodes → one fused node, γ per column."""
    packed = torch.cat([p["packed"] for p in parts], dim=-1)
    scale = torch.cat([p["scale"].expand(*p["scale"].shape[:-1],
                                         p["packed"].shape[-1])
                       for p in parts], dim=-1)
    return {"packed": packed, "scale": scale}


def _fuse_ffn(w_gate, w_up, w_down) -> dict:
    """Gate, up and down weights ([..., k, n]) → the whole-FFN node."""
    gu = _concat_packed([_quantize_linear(w_gate), _quantize_linear(w_up)])
    down = _quantize_linear(w_down)
    return {"gu_packed": gu["packed"], "gu_scale": gu["scale"],
            "down_packed": down["packed"], "down_scale": down["scale"]}


def quantize_layer(lp: dict) -> dict:
    """One layer's master weights → its fused serving layer."""
    attn = lp["attn"]
    wqkv = _concat_packed([_quantize_linear(attn[n]["w"])
                           for n in ("wq", "wk", "wv")])
    out = {"ln1": dict(lp["ln1"]), "ln2": dict(lp["ln2"]),
           "attn": {"wqkv": wqkv, "wo": _quantize_linear(attn["wo"]["w"])}}
    if "moe" in lp:
        moe = lp["moe"]
        out["moe"] = dict(_fuse_ffn(moe["w_gate"], moe["w_up"],
                                    moe["w_down"]), router=moe["router"])
    else:
        ffn = lp["ffn"]
        out["ffn"] = _fuse_ffn(ffn["w_gate"]["w"], ffn["w_up"]["w"],
                               ffn["w_down"]["w"])
    return out


def quantize_params(cfg, params: dict) -> dict:
    """Full master tree (layer-stacked) → serving tree."""
    layers = [quantize_layer({k: _index(v, i)
                              for k, v in params["layers"].items()})
              for i in range(cfg.n_layers)]
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = stack_trees(layers)
    return out


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]
