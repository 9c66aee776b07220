"""RWKV6 ("Finch"): attention-free token mixing with a data-dependent
decay (the reference's ``models/rwkv6.py``), serving and training forms.

Per head, with state S [dh, dh]:

    y_t = r_t · (S_{t-1} + diag(u)·k_t v_tᵀ)
    S_t = diag(w_t)·S_{t-1} + k_t v_tᵀ,   w_t = exp(−exp(w_base + LoRA(m_w)))

Prefill runs the recurrence over the prompt (:func:`_wkv`, in chunks of
``WKV_CHUNK`` steps through :func:`~repro_torch.models.scan_utils.
chunked_scan`); decode is the same code at T = 1, so the family's "cache"
is the state (``wkv`` [B, H, dh, dh]) and the last token's normed input
of each mix (``x_tm``, ``x_cm`` [B, 1, D]). Every projection is a
BitLinear: in serving format each is #1 (``fused_qlinear``), ten a
layer; the activations (silu of g, tanh of the LoRA's middle, relu² and
sigmoid of the channel mix) stay outside the kernel, as in the
reference. The wkv recurrence has no kernel in the reference and none
here: plain tensor ops a step.

``train=True`` gives the training forward (the reference's
``rwkv_layer_apply`` calls, on f32 masters): the projections take
``linear_apply``'s QAT product (f32 accumulation) instead of
``serving_linear``'s batch-invariant float64 one, and the wkv chunks are
rematerialized in the backward. The rest is the same code.

Numerics against XLA: the group norm's mean and variance are sums taken
in float64 and rounded once, times the f32 reciprocal of the count (as
:func:`repro_torch.models.layers.norm_apply` forms LayerNorm), and the
``einsum`` of a step is a float64 product rounded once, so a lane's value
does not depend on how many lanes share the call. Training keeps that
float64 product (it is differentiable, and the gradient then matches the
reference's f32 ``einsum`` to well within its 1e-4), so the trained and
the served forward are one computation. The rest is the reference's op
order in f32. The reference's ``shard`` constraints are no-ops off a mesh
and are dropped.
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import (_row_mean, linear_init,
                                       mixer_linear, silu)
from repro_torch.models.scan_utils import chunked_scan

W_LORA = 64
# steps of the wkv recurrence whose kv products and y are formed at once
WKV_CHUNK = 64


def rwkv_init(gen: torch.Generator, cfg, *, device) -> dict:
    """One layer's time- and channel-mix weights, f32 masters: the
    reference's ``rwkv_init`` tree (fan-in scaled projections, static
    token-shift lerps ``mu`` [5, d] and ``mu_c`` [2, d] of 0.5, the decay
    base −4, the LoRA pair, the bonus ``u`` ~ 0.1·N(0, 1) [H, dh] and the
    group norm's ``ln_x`` of ones)."""
    d, f, h, dh = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.hd

    def lin(d_in, d_out):
        return linear_init(gen, d_in, d_out, device=device)

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=device)
    p = {name: lin(d, d) for name in ("wr", "wk", "wv", "wg", "wo")}
    p["mu"] = full((5, d), 0.5)                    # r, k, v, g, w
    p["w_base"] = full((d,), -4.0)
    p["w_lora_a"] = lin(d, W_LORA)
    p["w_lora_b"] = lin(W_LORA, d)
    p["u"] = torch.randn((h, dh), generator=gen, device=device,
                         dtype=torch.float32) * 0.1
    p["ln_x"] = full((d,), 1.0)
    p["mu_c"] = full((2, d), 0.5)                  # r, k
    p["wk_c"] = lin(d, f)
    p["wv_c"] = lin(f, d)
    p["wr_c"] = lin(d, d)
    return p


def _group_norm(x: torch.Tensor, gamma: torch.Tensor, h: int, dh: int,
                eps: float = 1e-5) -> torch.Tensor:
    """Per-head layer norm of y [..., H, dh] (rwkv's ``ln_x``), without a
    bias: the population variance, the rsqrt rounded once from
    float64."""
    centered = x - _row_mean(x)
    var = _row_mean(centered * centered)
    inv = torch.rsqrt((var + eps).to(torch.float64)).to(torch.float32)
    return centered * inv * gamma.reshape(h, dh)


def _shift(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """Each token's predecessor: x_prev [B, 1, D], then x[:, :-1]."""
    return torch.cat([x_prev.to(x.dtype), x[:, :-1]], dim=1)


def _time_mix_inputs(cfg, p, x, x_prev, train: bool = False):
    """Token-shift mixes and projections of the whole sequence. x [B, T,
    D]; x_prev [B, 1, D] (the token before x[:, 0]). → r, k, v and the
    per-channel decay w in (0, 1), each [B, T, H, dh], and the gate g
    [B, T, D]."""
    b, t, _ = x.shape
    delta = _shift(x, x_prev) - x
    mixes = [x + p["mu"][i].to(x.dtype) * delta for i in range(5)]
    q, lin = cfg.quant, mixer_linear(train)
    r = lin(p["wr"], mixes[0], quant=q)
    k = lin(p["wk"], mixes[1], quant=q)
    v = lin(p["wv"], mixes[2], quant=q)
    g = silu(lin(p["wg"], mixes[3], quant=q))
    lora = lin(p["w_lora_b"],
               torch.tanh(lin(p["w_lora_a"], mixes[4], quant=q)), quant=q)
    w = torch.exp(-torch.exp(p["w_base"] + lora))
    heads = [a.reshape(b, t, cfg.n_heads, cfg.hd) for a in (r, k, v, w)]
    return (*heads, g)


def _wkv_chunk(u, state, xs):
    """A chunk of the wkv recurrence, the reference's ``_wkv_step`` over
    its steps: xs = (r, k, v, w) [C, B, H, dh]; state S [B, H, dh, dh] →
    (S after the chunk, y [C, B, H, dh]).

    A step is the reference's arithmetic: ``kv = k_t v_tᵀ``, ``m = S +
    u·kv``, ``y_t = r_t·m``, ``S = w_t·S + kv``. Only the carried state
    is sequential, so the chunk forms its kv and u·kv products at once,
    runs the three state ops a step, and takes its y from the stacked m
    in one float64 product rounded once (a lane's value does not depend
    on how many lanes or steps share the call): the same values as a
    step-at-a-time loop, with a third of its launches a step.
    """
    r, k, v, w = xs
    kv = k[..., :, None] * v[..., None, :]
    ukv = u[..., None] * kv
    ms = []
    for t in range(kv.shape[0]):
        ms.append(state + ukv[t])
        state = w[t][..., :, None] * state + kv[t]
    m = torch.stack(ms).to(torch.float64)
    y = torch.matmul(r[..., None, :].to(torch.float64), m)[..., 0, :]
    return state, y.to(torch.float32)


def _wkv(u, r, k, v, w, state, *, remat: bool = False):
    """The wkv recurrence over T steps: r, k, v, w [T, B, H, dh]; state S
    [B, H, dh, dh] → (S after step T, y [T, B, H, dh]), in chunks of
    ``WKV_CHUNK`` steps through :func:`chunked_scan` (each chunk
    recomputed in the backward under ``remat``)."""
    return chunked_scan(lambda s, xs: _wkv_chunk(u, s, xs), state,
                        (r, k, v, w), chunk=WKV_CHUNK, remat=remat,
                        params=(u,))


def rwkv_time_mix(cfg, p, x, x_prev, state, *, train: bool = False):
    """x [B, T, D], x_prev [B, 1, D], state [B, H, dh, dh] → (out [B, T,
    D], the last token's x [B, 1, D], the state after step T).
    ``train``: the training forward (module docstring)."""
    b, t, d = x.shape
    r, k, v, w, g = _time_mix_inputs(cfg, p, x, x_prev, train)
    state, ys = _wkv(p["u"], *(a.transpose(0, 1) for a in (r, k, v, w)),
                     state, remat=train)
    y = _group_norm(ys.transpose(0, 1), p["ln_x"], cfg.n_heads, cfg.hd)
    y = (y.reshape(b, t, d) * g).to(x.dtype)
    return mixer_linear(train)(p["wo"], y, quant=cfg.quant), x[:, -1:], state


def rwkv_channel_mix(cfg, p, x, x_prev, *, train: bool = False):
    """x [B, T, D], x_prev [B, 1, D] → (out [B, T, D], the last token's x
    [B, 1, D]). ``train``: the training forward."""
    delta = _shift(x, x_prev) - x
    m_r = x + p["mu_c"][0].to(x.dtype) * delta
    m_k = x + p["mu_c"][1].to(x.dtype) * delta
    q, lin = cfg.quant, mixer_linear(train)
    k = torch.square(torch.relu(lin(p["wk_c"], m_k, quant=q)))
    r = torch.sigmoid(lin(p["wr_c"], m_r, quant=q))
    out = (r * lin(p["wv_c"], k, quant=q)).to(x.dtype)
    return out, x[:, -1:]


def rwkv_state_shape(cfg, batch: int) -> dict:
    """One layer's decode state: name → (shape, dtype)."""
    return {"wkv": ((batch, cfg.n_heads, cfg.hd, cfg.hd), torch.float32),
            "x_tm": ((batch, 1, cfg.d_model), torch.float32),
            "x_cm": ((batch, 1, cfg.d_model), torch.float32)}
