"""Master weights → the serving (deployment) format, every family.

Every projection becomes packed 2-bit ternary codes plus its absmean γ,
and projection groups fuse into one packed stream each, as the reference's
``quantize_params(fuse=True)`` does:

  * ``attn.{wq,wk,wv,wo}`` → ``attn.wqkv`` (codes concatenated along the
    output axis, a per-column γ row so each column keeps its own
    projection's scalar γ, and ``b = concat(bq, bk, bv)`` when all three
    carry a bias) and ``attn.wo`` (scalar γ, shape [1, 1]);
  * the cross-attention ``xattn.{wq,wk,wv,wo}`` → ``xattn.wkv`` (K ‖ V
    fused the same way: both read the encoder memory), ``xattn.wq`` (its
    own node, keeping its bias) and ``xattn.wo``;
  * ``ffn.{w_gate,w_up,w_down}`` → ``gu_packed``/``gu_scale`` (gate ‖ up,
    per-column γ row; ``up`` alone for an ungated FFN) and
    ``down_packed``/``down_scale``;
  * ``moe.{w_gate,w_up,w_down}`` expert stacks [E, k, n] fuse the same way
    with a leading expert axis and one γ per expert and stream
    (``gu_scale`` [E, 1, 2f], ``down_scale`` [E, 1, 1]), so a layer's
    expert FFNs are one dispatch; ``moe.router`` stays f32.

  * the recurrent mixers' projections (rwkv6's ``tm.{wr,wk,wv,wg,wo,
    w_lora_a,w_lora_b,wk_c,wv_c,wr_c}``, Mamba's ``in_proj``, ``x_proj``,
    ``dt_proj`` with its bias, ``out_proj``) each → its own packed node
    where the reduction k is a multiple of 4 and at least 16 (the
    reference's ``_eligible``); a smaller one (reduced jamba's
    ``dt_proj``, k 8) stays ``{"w", "b"}`` in f32. Their other tensors
    (``mu``, ``mu_c``, ``u``, ``w_base``, ``ln_x``, ``A_log``, ``D``,
    ``conv_w``, ``conv_b``: the reference's ``_KEEP_FP``) stay f32.

Embedding, norms, head, router and the vlm ``projector`` stay f32 (the
reference's ``_KEEP_FP``). Layer-stacked trees
(``layers``, the encoder's ``enc_layers``, and hybrid's ``blocks`` of
``sub{j}`` sublayers over the superblocks) keep their leading axis.

:func:`init_serving_params` draws and quantizes a seeded model one stack
entry at a time (a hybrid superblock one sublayer at a time), so a model
whose f32 master tree does not fit the card but whose serving tree does
(llava-next-34b, mistral-nemo-12b, mixtral-8x22b, a full-width jamba
superblock) is served from a seed.
"""

from __future__ import annotations

import torch

from repro_torch.core.ternary import pack_ternary, ternary_quantize
from repro_torch.models.transformer import draw_params, stack_trees


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


# tensors of the recurrent mixers that stay f32 even when 2-D
_KEEP_FP = ("mu", "mu_c", "u", "w_base", "ln_x", "A_log", "D", "conv_w",
            "conv_b")


def _eligible(k: int) -> bool:
    """Whether a projection of reduction k packs (four codes a byte, and
    not too small to be worth a kernel), as the reference decides."""
    return k % 4 == 0 and k >= 16


def _concat_packed(parts: list) -> dict:
    """Per-projection packed nodes → one fused node, γ per column."""
    packed = torch.cat([p["packed"] for p in parts], dim=-1)
    scale = torch.cat([p["scale"].expand(*p["scale"].shape[:-1],
                                         p["packed"].shape[-1])
                       for p in parts], dim=-1)
    return {"packed": packed, "scale": scale}


def _fuse_ffn(w_up, w_down, w_gate=None) -> dict:
    """Up, down and (gated) gate weights ([..., k, n]) → the whole-FFN
    node."""
    parts = ([] if w_gate is None else [w_gate]) + [w_up]
    gu = _concat_packed([_quantize_linear(w) for w in parts])
    down = _quantize_linear(w_down)
    return {"gu_packed": gu["packed"], "gu_scale": gu["scale"],
            "down_packed": down["packed"], "down_scale": down["scale"]}


def _node(lin: dict) -> dict:
    """One linear ``{"w", "b"?}`` → its own packed node, bias kept."""
    out = _quantize_linear(lin["w"])
    if "b" in lin:
        out["b"] = lin["b"]
    return out


def _mixer(p: dict) -> dict:
    """An rwkv6 ``tm`` or a Mamba sublayer → serving format: each eligible
    projection its own packed node (bias kept), the rest as it is."""
    return {name: val if name in _KEEP_FP
            else _node(val) if _eligible(val["w"].shape[-2]) else dict(val)
            for name, val in p.items()}


def _fuse_attn(attn: dict, fuse_q: bool) -> dict:
    """Self-attention (``fuse_q``: Q ‖ K ‖ V in ``wqkv``) or cross-attention
    (K ‖ V in ``wkv``, ``wq`` its own node) → the fused serving node.
    Biases follow the reference's all-or-none rule: the fused node carries
    the concatenated ``b`` when every fused projection has one. With some
    but not all, the reference keeps the projections unfused, which this
    engine does not serve."""
    names = ("wq", "wk", "wv") if fuse_q else ("wk", "wv")
    subs = [attn[name] for name in names]
    fused = _concat_packed([_quantize_linear(sub["w"]) for sub in subs])
    has_b = ["b" in sub for sub in subs]
    if any(has_b) and not all(has_b):
        raise NotImplementedError(
            f"a bias on some of {names} but not all: the reference serves "
            f"them unfused, which is not ported")
    if all(has_b):
        fused["b"] = torch.cat([sub["b"] for sub in subs], dim=-1)
    out = {"wqkv" if fuse_q else "wkv": fused}
    if not fuse_q:
        out["wq"] = _node(attn["wq"])
    out["wo"] = _node(attn["wo"])
    return out


def quantize_layer(lp: dict) -> dict:
    """One layer's master weights → its fused serving layer (norms carried
    as they are)."""
    out = {key: dict(val) for key, val in lp.items()
           if key.startswith("ln")}
    if "attn" in lp:
        out["attn"] = _fuse_attn(lp["attn"], fuse_q=True)
    for key in ("tm", "mamba"):
        if key in lp:
            out[key] = _mixer(lp[key])
    if "xattn" in lp:
        out["xattn"] = _fuse_attn(lp["xattn"], fuse_q=False)
    if "moe" in lp:
        moe = lp["moe"]
        out["moe"] = dict(_fuse_ffn(moe["w_up"], moe["w_down"],
                                    moe["w_gate"]), router=moe["router"])
    elif "ffn" in lp:
        ffn = lp["ffn"]
        out["ffn"] = _fuse_ffn(ffn["w_up"]["w"], ffn["w_down"]["w"],
                               ffn["w_gate"]["w"] if "w_gate" in ffn
                               else None)
    return out


def _quantize_entry(name: str, tree: dict) -> dict:
    """One entry of a stack → serving format: a layer, or (``blocks``)
    ``sub{j}`` sublayers of a superblock, each quantized as a layer."""
    if name == "blocks":
        return {sub: quantize_layer(lp) for sub, lp in tree.items()}
    return quantize_layer(tree)


def quantize_params(cfg, params: dict) -> dict:
    """Full master tree (layer- or superblock-stacked) → serving tree."""
    out = {}
    for name, val in params.items():
        if name not in ("enc_layers", "layers", "blocks"):
            out[name] = val
            continue
        n = (cfg.n_encoder_layers if name == "enc_layers" else
             cfg.n_layers // cfg.attn_every if name == "blocks" else
             cfg.n_layers)
        out[name] = stack_trees([_quantize_entry(name, _index(val, i))
                                 for i in range(n)])
    return out


def init_serving_params(cfg, seed: int, device="cpu") -> dict:
    """The serving tree of ``quantize_params(cfg, init_params(cfg, seed,
    device))``, bitwise, without the whole f32 master tree: each stack
    entry (a superblock's sublayer) is drawn
    (:func:`repro_torch.models.transformer.draw_params`), quantized and
    written into a stacked serving tree allocated once, from the first
    entry's shapes, before the next entry is drawn. The peak is the
    serving tree, one entry's masters and the quantizer's temporaries.

    Bitwise equality holds because both paths make the same
    ``torch.randn`` calls, with the same shapes, in the same order (the
    generator's offset advances by each call's size, so one reordered,
    merged or extra draw changes every later weight), and nothing in the
    quantizer draws from a generator."""
    out = {}
    for name, i, n, tree in draw_params(cfg, seed, device):
        if i is None:
            out[name] = tree
            continue
        entry = _quantize_entry(name, tree)
        del tree
        if i == 0:
            out.setdefault(name, {}).update(_empty_stack(entry, n))
        _write_entry(out[name], i, entry)
        del entry
    return out


def _empty_stack(tree, n: int):
    if isinstance(tree, dict):
        return {k: _empty_stack(v, n) for k, v in tree.items()}
    return torch.empty((n, *tree.shape), dtype=tree.dtype,
                       device=tree.device)


def _write_entry(stack, i: int, tree) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            _write_entry(stack[k], i, v)
        else:
            stack[k][i].copy_(v)


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]
