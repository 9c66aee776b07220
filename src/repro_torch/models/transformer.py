"""Model parameters (dense, moe, encdec, ssm, hybrid and vlm families),
drawn from an explicit ``torch.Generator``.

The tree mirrors the reference's ``init_params``: ``embed.table``,
``ln_f``, ``head.w`` and layer-stacked ``layers`` with ``ln1``,
``attn.{wq,wk,wv,wo}`` (``wq/wk/wv`` with a zero ``b`` when the config
has ``qkv_bias``), ``ln2`` and either ``ffn.{w_gate,w_up,w_down}`` (no
``w_gate`` when the FFN is ungated) or ``moe`` (the reference's
``moe_init``: ``router`` [d, E] and the expert stacks ``w_gate``/``w_up``
[E, d, f] and ``w_down`` [E, f, d] as raw tensors). A norm is ``{"g"}``,
or ``{"g", "b"}`` under LayerNorm. The encdec family adds the encoder
stack ``enc_layers`` (decoder layers without cross-attention) and its
final norm ``ln_enc``, and its decoder layers carry ``ln_x`` and the
cross-attention ``xattn``. The ssm family (rwkv6) stacks ``layers`` of
``ln1``, ``tm`` (:func:`repro_torch.models.rwkv6.rwkv_init`, the time and
channel mix together) and ``ln2``; the hybrid family (jamba) stacks
``blocks`` over ``n_layers // attn_every`` superblocks, each
``sub0`` … ``sub{attn_every-1}`` of ``ln1``, ``attn`` (the one attention
sublayer, at ``attn_every // 2``) or ``mamba``
(:func:`repro_torch.models.mamba.mamba_init`), ``ln2``, and ``moe`` (odd
positions) or ``ffn``. The vlm family (llava) is the dense layer stack
and the patch projector ``projector`` ``{"w"}`` [d, d] (the reference's
``linear_init``), drawn after the layers. The reference uses ``jax.random`` — the same seed
gives other numbers, so tests carry the reference's weights over with
:mod:`repro_torch.convert`.

:func:`forward_train` is the training forward (QAT BitLinear everywhere,
f32 norms, softmax and logits; the residual stream in ``act_dtype``) of
every family, over the f32 master tree, with per-layer
rematerialization: decoder layers (dense, moe, vlm; encdec's encoder and
decoder stacks), :func:`rwkv_layer_apply` over ``layers`` (ssm) and
:func:`superblock_apply` over ``blocks`` (hybrid), whose recurrent scans
also rematerialize each chunk of 64 steps inside the layer's own
checkpoint.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import attention_apply
from repro_torch.models.layers import (embedding_apply, ffn_apply,
                                       head_apply, linear_init, norm_apply,
                                       norm_init)
from repro_torch.models import rwkv6
from repro_torch.models.mamba import mamba_forward, mamba_init
from repro_torch.models.moe import train_moe_apply


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
    expert stacks, each scaled by its fan-in^-0.5 in place (a full-width
    jamba stack is 12.9 GB: no second copy while it is drawn)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts

    def draw(*shape, fan_in):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).mul_(fan_in ** -0.5)
    return {"router": draw(d, e, fan_in=d),
            "w_gate": draw(e, d, f, fan_in=d),
            "w_up": draw(e, d, f, fan_in=d),
            "w_down": draw(e, f, d, fan_in=f)}


def _attention_init(gen, cfg, *, device) -> dict:
    d, bias = cfg.d_model, cfg.qkv_bias
    return {"wq": linear_init(gen, d, cfg.q_dim, device=device, bias=bias),
            "wk": linear_init(gen, d, cfg.kv_dim, device=device, bias=bias),
            "wv": linear_init(gen, d, cfg.kv_dim, device=device, bias=bias),
            "wo": linear_init(gen, cfg.q_dim, d, device=device)}


def _layer_init(gen, cfg, i: int, *, device, cross: bool = False,
                mixer: str = "attn") -> dict:
    """One decoder (or, without ``cross``, encoder) layer's master
    weights, drawn attention (or, with ``mixer="mamba"``, the Mamba
    sublayer) first, then cross-attention, then the FFN or MoE of layer
    position ``i``."""
    d, f = cfg.d_model, cfg.d_ff
    layer = {"ln1": norm_init(d, cfg.norm, device=device),
             mixer: (_attention_init(gen, cfg, device=device)
                     if mixer == "attn" else
                     mamba_init(gen, cfg, device=device))}
    if cross:
        layer["ln_x"] = norm_init(d, cfg.norm, device=device)
        layer["xattn"] = _attention_init(gen, cfg, device=device)
    layer["ln2"] = norm_init(d, cfg.norm, device=device)
    if cfg.is_moe_layer(i):
        layer["moe"] = moe_init(gen, cfg, device=device)
        return layer
    names = ("w_gate", "w_up") if cfg.gated_ffn else ("w_up",)
    ffn = {name: linear_init(gen, d, f, device=device) for name in names}
    ffn["w_down"] = linear_init(gen, f, d, device=device)
    layer["ffn"] = ffn
    return layer


def rwkv_layer_init(gen, cfg, *, device) -> dict:
    """One rwkv6 layer: ``ln1``, the time and channel mix ``tm``,
    ``ln2``."""
    d = cfg.d_model
    return {"ln1": norm_init(d, cfg.norm, device=device),
            "tm": rwkv6.rwkv_init(gen, cfg, device=device),
            "ln2": norm_init(d, cfg.norm, device=device)}


def sublayer_init(gen, cfg, j: int, *, device) -> dict:
    """Sublayer ``sub{j}`` of a jamba superblock: an attention or Mamba
    sublayer and an FFN or MoE by its position ``j``."""
    return _layer_init(gen, cfg, j, device=device,
                       mixer="attn" if cfg.is_attn_layer(j) else "mamba")


def draw_params(cfg, seed: int, device="cpu"):
    """The master tree's entries in draw order, from one generator seeded
    with ``seed``: embed, ``ln_f``, head, then (encdec) the encoder layers
    and ``ln_enc``, then the decoder layers (ssm: rwkv layers; hybrid:
    superblocks), then (vlm) the projector. Yields ``(name, i, n, tree)``:
    a top-level entry with ``i`` and ``n`` None, or entry ``i`` of the
    ``n`` of the stack ``name`` (``enc_layers``, ``layers``, ``blocks``),
    each drawn only when it is asked for. A superblock comes one sublayer
    at a time, ``tree`` then ``{"sub{j}": sublayer}``: entry ``i`` is the
    union of the trees yielded for it, and one full-width jamba sublayer's
    masters (~40 GB) are at most what a draw holds, where its superblock's
    are ~176 GB. :func:`init_params` and the
    streamed draw (:func:`repro_torch.serving.quantize.
    init_serving_params`) both walk it, so they make the same
    ``torch.randn`` calls with the same shapes in the same order. On the
    ``meta`` device nothing is drawn (there is no meta generator): the
    entries carry the tree's shapes and dtypes alone, the dry-run's
    abstract parameters."""
    gen = None
    if torch.device(device).type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    d, vp = cfg.d_model, cfg.vocab_padded
    yield "embed", None, None, {"table": torch.randn(
        (vp, d), generator=gen, device=device) * 0.02}
    yield "ln_f", None, None, norm_init(d, cfg.norm, device=device)
    yield "head", None, None, linear_init(gen, d, vp, device=device)
    if cfg.family == "ssm":
        for i in range(cfg.n_layers):
            yield "layers", i, cfg.n_layers, rwkv_layer_init(
                gen, cfg, device=device)
        return
    if cfg.family == "hybrid":
        n = cfg.n_layers // cfg.attn_every
        for i in range(n):
            for j in range(cfg.attn_every):
                yield "blocks", i, n, {f"sub{j}": sublayer_init(
                    gen, cfg, j, device=device)}
        return
    encdec = cfg.family == "encdec"
    if encdec:
        for i in range(cfg.n_encoder_layers):
            yield "enc_layers", i, cfg.n_encoder_layers, _layer_init(
                gen, cfg, i, device=device)
        yield "ln_enc", None, None, norm_init(d, cfg.norm, device=device)
    for i in range(cfg.n_layers):
        yield "layers", i, cfg.n_layers, _layer_init(
            gen, cfg, i, device=device, cross=encdec)
    if cfg.family == "vlm":
        yield "projector", None, None, linear_init(gen, d, d, device=device)


def init_params(cfg, seed: int, device="cpu") -> dict:
    """Full f32 master tree of any family, the entries of
    :func:`draw_params` with each stack's layers stacked."""
    params = {}
    for name, i, n, tree in draw_params(cfg, seed, device):
        if i is None:
            params[name] = tree
        else:
            params.setdefault(name, [{} for _ in range(n)])[i].update(tree)
    return {name: stack_trees(val) if isinstance(val, list) else val
            for name, val in params.items()}


# the reference's logical partition specs (its ``*_init`` functions' second
# return value): a linear's ``w`` is (fsdp, tp) unless named here, its
# bias the last entry of that; the other leaves by name
_LINEAR_SPECS = {"wo": ("tp", "fsdp"), "w_down": ("tp", "fsdp"),
                 "wv_c": ("tp", "fsdp"), "out_proj": ("tp", "fsdp"),
                 "x_proj": ("tp", None), "dt_proj": (None, "tp"),
                 "w_lora_a": ("fsdp", None), "w_lora_b": (None, "tp")}
_LEAF_SPECS = {"table": ("tp", "fsdp"), "router": (None, None),
               "mu": (None, None), "mu_c": (None, None), "u": (None, None),
               "w_base": ("tp",), "ln_x": (None,), "conv_w": (None, "tp"),
               "conv_b": ("tp",), "A_log": ("tp", None), "D": ("tp",)}
_EXPERT_SPECS = {"w_gate": (None, "fsdp", "tp"), "w_up": (None, "fsdp", "tp"),
                 "w_down": (None, "tp", "fsdp")}
_STACKS = ("layers", "enc_layers", "blocks")


def param_specs(cfg, params: dict) -> dict:
    """The reference's ``init_params`` partition specs for the master tree
    ``params`` (of ``cfg``'s family): a tree of the same structure whose
    leaves are tuples of logical axes (``"fsdp"``, ``"tp"`` or None) for
    the leading dims, with a leading None on every layer-stacked leaf.
    :func:`repro_torch.distributed.partitioning.leaf_dims` resolves them
    against a mesh."""
    del cfg

    def walk(node, name, parent):
        if isinstance(node, dict):
            if "w" in node and torch.is_tensor(node["w"]):
                w = _LINEAR_SPECS.get(name, ("fsdp", "tp"))
                return {k: w if k == "w" else (w[-1],) for k in node}
            return {k: walk(v, k, name) for k, v in node.items()}
        if parent == "moe" and name in _EXPERT_SPECS:
            return _EXPERT_SPECS[name]
        return _LEAF_SPECS.get(name, (None,))

    out = {}
    for name, node in params.items():
        spec = walk(node, name, None)
        if name in _STACKS:
            spec = _map_specs(lambda sp: (None, *sp), spec)
        out[name] = spec
    return out


def _map_specs(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------------------
# training forward
# ---------------------------------------------------------------------------

def decoder_layer_apply(cfg, p, x, *, positions, causal=True, cross_kv=None,
                        chunk_ctx=None):
    """One decoder (or encoder) layer on f32 masters → (x, aux). With
    ``chunk_ctx`` (the whole pre-layer stream prefix ‖ x) x is a suffix
    chunk whose queries attend the whole context at their global offset;
    ``cross_kv`` adds cross-attention over the encoder memory."""
    h = norm_apply(p["ln1"], x, cfg.norm)
    if chunk_ctx is None:
        x = x + attention_apply(cfg, p["attn"], h, positions=positions,
                                causal=causal)
    else:
        hk = norm_apply(p["ln1"], chunk_ctx, cfg.norm)
        x = x + attention_apply(cfg, p["attn"], h, kv_x=hk, causal=causal,
                                positions=positions, chunk_carry=True,
                                q_offset=chunk_ctx.shape[1] - x.shape[1])
    if cross_kv is not None:
        h = norm_apply(p["ln_x"], x, cfg.norm)
        x = x + attention_apply(cfg, p["xattn"], h, kv_x=cross_kv,
                                use_rope=False)
    return _mixer_ffn(cfg, p, x)


def _mixer_ffn(cfg, sub, x):
    """A sublayer's second half, ``ln2`` then the MoE (odd positions) or
    the FFN, with its residual. → (x, aux)."""
    h = norm_apply(sub["ln2"], x, cfg.norm)
    if "moe" in sub:
        y, aux = train_moe_apply(cfg, sub["moe"], h)
    else:
        y = ffn_apply(cfg, sub["ffn"], h)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + y, aux


def superblock_apply(cfg, p, x, *, positions):
    """One jamba superblock on f32 masters: per sublayer ``sub{j}``, ``ln1``
    then attention (the one attention position) or the training Mamba
    forward, then the MoE or FFN. → (x, the MoE aux summed over the
    superblock)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for j in range(cfg.attn_every):
        sub = p[f"sub{j}"]
        h = norm_apply(sub["ln1"], x, cfg.norm)
        if "attn" in sub:
            x = x + attention_apply(cfg, sub["attn"], h, positions=positions)
        else:
            x = x + mamba_forward(cfg, sub["mamba"], h, train=True)[0]
        x, a = _mixer_ffn(cfg, sub, x)
        aux = aux + a
    return x, aux


def rwkv_layer_apply(cfg, p, x):
    """One rwkv6 layer on f32 masters, from a zero token shift and a zero
    wkv state: ``ln1`` → the time mix, ``ln2`` → the channel mix, each
    with its residual."""
    b = x.shape[0]
    zeros_prev = torch.zeros((b, 1, cfg.d_model), dtype=x.dtype,
                             device=x.device)
    state0 = torch.zeros((b, cfg.n_heads, cfg.hd, cfg.hd),
                         dtype=torch.float32, device=x.device)
    h = norm_apply(p["ln1"], x, cfg.norm)
    x = x + rwkv6.rwkv_time_mix(cfg, p["tm"], h, zeros_prev, state0,
                                train=True)[0]
    h = norm_apply(p["ln2"], x, cfg.norm)
    return x + rwkv6.rwkv_channel_mix(cfg, p["tm"], h, zeros_prev,
                                      train=True)[0]


class _LayerOf(torch.autograd.Function):
    """Layer ``i`` of a stacked master leaf, whose gradient is added
    straight into the leaf's ``.grad`` at ``[i]`` (allocated zero on first
    use). Autograd's own slice gradient is a zero tensor of the whole
    stack a layer (or, through ``unbind``, every layer's gradient held
    until one stacked copy is made): at full width that is a second 13.7
    GB of gradients. The leaf itself gets no gradient through the graph,
    so ``.grad`` accumulates across backward passes as autograd's does."""

    @staticmethod
    def forward(ctx, leaf, i):
        ctx.leaf, ctx.i = leaf, i
        return leaf[i]

    @staticmethod
    def backward(ctx, grad):
        leaf = ctx.leaf
        if leaf.grad is None:
            leaf.grad = torch.zeros_like(leaf)
        leaf.grad[ctx.i] += grad
        return None, None


def _layer_of(stacked, i: int):
    """Layer ``i`` of a stacked tree: a master leaf that takes gradients
    goes through :class:`_LayerOf`, anything else is a plain view."""
    if isinstance(stacked, dict):
        return {k: _layer_of(v, i) for k, v in stacked.items()}
    if stacked.is_leaf and stacked.requires_grad and \
            torch.is_grad_enabled():
        return _LayerOf.apply(stacked, i)
    return stacked[i]


def _scan_stack(body, x, stacked, *, remat: bool = True, gather=None):
    """``body(x, layer) → (x, aux)`` over a stacked tree's layers in order,
    aux summed from f32 zero. With ``remat`` each layer's activations are
    recomputed in the backward (``torch.utils.checkpoint``, non-reentrant),
    as the reference checkpoints its scan step. ``gather`` (a layer's
    shards → the whole layer) runs inside the layer's checkpoint, so a
    gathered layer lives only while it runs, in the forward and again in
    the backward."""
    n = next(iter(_leaves(stacked))).shape[0]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if gather is not None:
        body = lambda h, lp, body=body: body(h, gather(lp))  # noqa: E731
    for i in range(n):
        lp = _layer_of(stacked, i)
        if remat and torch.is_grad_enabled():
            x, a = checkpoint(body, x, lp, use_reentrant=False)
        else:
            x, a = body(x, lp)
        aux = aux + a
    return x, aux


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def forward_train(cfg, params, tokens, *, frames=None, patches=None,
                  remat: bool = True, gather=None):
    """→ (logits f32 [B, T_text, vocab_padded], moe aux f32).

    tokens [B, T]; frames [B, S_audio, D] (encdec's stub frontend);
    patches [B, n_img, D] (vlm's stub vision tower: through the projector
    in the activation dtype ahead of the text, whose positions alone
    come out). The residual stream runs in ``cfg.act_dtype``; norms,
    softmax and the logits stay f32; the masters are f32, cast at use.

    ``gather(tree, name)`` (the sharded training step's) turns the shards
    of the top-level entry ``name``, or of one layer of the stack
    ``name``, into the whole tree: top-level entries are gathered here,
    each stack's layers inside their remat."""
    if gather is not None:
        params = {k: v if k in _STACKS else gather(v, k)
                  for k, v in params.items()}

    def layer_gather(name):
        return None if gather is None else (lambda lp: gather(lp, name))
    act = getattr(torch, cfg.act_dtype)
    x = embedding_apply(params["embed"], tokens).to(act)
    t = tokens.shape[1]
    positions = torch.arange(t, device=x.device)[None, :]
    cross = None
    if cfg.family == "vlm":
        if patches is None:
            raise ValueError("the vlm family trains on patches")
        proj = patches.to(act) @ params["projector"]["w"].to(act)
        x = torch.cat([proj, x], dim=1)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    elif cfg.family == "encdec":
        if frames is None:
            raise ValueError("the encdec family trains on frames")
        enc = frames.to(act)
        enc_pos = torch.arange(enc.shape[1], device=x.device)[None, :]
        enc, _ = _scan_stack(
            lambda e, lp: decoder_layer_apply(cfg, lp, e, positions=enc_pos,
                                              causal=False),
            enc, params["enc_layers"], remat=remat,
            gather=layer_gather("enc_layers"))
        cross = norm_apply(params["ln_enc"], enc, cfg.norm)
    if cfg.family == "ssm":
        body = lambda h, lp: (rwkv_layer_apply(cfg, lp, h),  # noqa: E731
                              torch.zeros((), dtype=torch.float32,
                                          device=h.device))
    elif cfg.family == "hybrid":
        body = lambda h, bp: superblock_apply(  # noqa: E731
            cfg, bp, h, positions=positions)
    else:
        body = lambda h, lp: decoder_layer_apply(  # noqa: E731
            cfg, lp, h, positions=positions, cross_kv=cross)
    stack = "blocks" if cfg.family == "hybrid" else "layers"
    x, aux = _scan_stack(body, x, params[stack], remat=remat,
                         gather=layer_gather(stack))
    if cfg.family == "vlm":
        x = x[:, patches.shape[1]:]
    x = norm_apply(params["ln_f"], x, cfg.norm)
    return head_apply(params["head"], x), aux
