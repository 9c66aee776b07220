"""Mamba (selective SSM), the non-attention layer of jamba: serving and
training forwards (the reference's ``models/mamba.py``).

Prefill projects x, z, dt, B and C for the whole prompt and runs the
state recurrence ``h [B, Di, S]`` over it with :func:`chunked_scan`;
decode is one step of the same body on the carried state, whose other
half is the depthwise causal conv's last ``ck − 1`` inputs ``conv [B, ck −
1, Di]``. The projections are BitLinears: ``in_proj``, ``x_proj``,
``out_proj`` and, where k = ``dt_rank`` is at least 16, ``dt_proj`` (with
its bias) are #1 (``fused_qlinear``) in serving format; a smaller
``dt_proj`` (reduced jamba's, k 8) stays f32 and runs the QAT BitLinear
forward, as the reference serves it. The recurrence and the conv have no
kernel in the reference and none here.

``mamba_forward(..., train=True)`` is the training forward (the
reference's ``superblock_apply`` call, on f32 masters): every projection,
``dt_proj`` with its bias, takes ``linear_apply``'s QAT product (f32
accumulation) instead of ``serving_linear``'s float64 one, and the scan's
chunks of 64 steps are rematerialized in the backward.

Numerics against XLA: softplus is the reference's ``logaddexp(x, 0)``
(not ``torch.nn.functional.softplus``, which switches to x above 20),
silu is x·sigmoid(x), and a step's ``einsum`` is a float64 product
rounded once, so a lane does not depend on the others. Training keeps
that product (differentiable; its gradient is the f32 ``einsum``'s to
well within 1e-4), so the trained and the served forward are one
computation. The reference's ``shard`` constraints are no-ops off a mesh
and are dropped.
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import linear_init, mixer_linear, silu
from repro_torch.models.scan_utils import chunked_scan, stepwise


def dt_rank(cfg) -> int:
    return -(-cfg.d_model // 16)


def mamba_init(gen: torch.Generator, cfg, *, device) -> dict:
    """One Mamba layer's f32 masters, the reference's ``mamba_init`` tree:
    ``in_proj`` [d, 2·Di], ``x_proj`` [Di, r + 2S], ``dt_proj`` [r, Di]
    with a zero bias, the conv's ``conv_w`` ~ 0.1·N(0, 1) [ck, Di] and zero
    ``conv_b``, the S4 init ``A_log`` = log(1..S) a channel, ``D`` ones and
    ``out_proj`` [Di, d]."""
    d, di, s, ck = cfg.d_model, cfg.d_inner, cfg.mamba_d_state, cfg.mamba_conv
    r = dt_rank(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    p = {"in_proj": linear_init(gen, d, 2 * di, device=device),
         "x_proj": linear_init(gen, di, r + 2 * s, device=device),
         "dt_proj": linear_init(gen, r, di, device=device, bias=True)}
    p["conv_w"] = torch.randn((ck, di), generator=gen, **f32) * 0.1
    p["conv_b"] = torch.zeros(di, **f32)
    p["A_log"] = torch.log(torch.arange(1, s + 1, **f32)).expand(
        di, s).contiguous()
    p["D"] = torch.ones(di, **f32)
    p["out_proj"] = linear_init(gen, di, d, device=device)
    return p


def softplus(x: torch.Tensor) -> torch.Tensor:
    """The reference's softplus, logaddexp(x, 0) = max(x, 0) +
    log1p(exp(−|x|)). |x| is formed as ``where(x ≥ 0, x, −x)`` (the same
    values) so that the gradient at x = 0 is logaddexp's ½: ``abs``'s
    sign(0) = 0 would leave ``clamp_min``'s 1 alone (a ``dt_proj`` column
    of ternary zeros puts every token there)."""
    mag = torch.where(x >= 0, x, -x)
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-mag))


def _causal_conv(x, conv_w, conv_b, conv_state=None):
    """Depthwise causal conv. x [B, T, Di]; conv_w [ck, Di]; conv_state
    [B, ck − 1, Di] (decode) the history, zeros (prefill) without. → (y
    [B, T, Di], the last ck − 1 inputs as the new state)."""
    ck = conv_w.shape[0]
    if conv_state is None:
        xp = torch.nn.functional.pad(x, (0, 0, ck - 1, 0))
    else:
        xp = torch.cat([conv_state, x], dim=1)
    t = x.shape[1]
    y = xp[:, 0:t] * conv_w[0]
    for i in range(1, ck):
        y = y + xp[:, i:i + t] * conv_w[i]
    return y + conv_b, xp[:, xp.shape[1] - (ck - 1):]


def _ssm_inputs(cfg, p, u, train: bool = False):
    """u [B, T, D] → x, z [B, T, Di] (``in_proj``, split)."""
    xz = mixer_linear(train)(p["in_proj"], u, quant=cfg.quant)
    return torch.chunk(xz, 2, dim=-1)


def _ssm_project(cfg, p, x, train: bool = False):
    """x [B, T, Di] → dt [B, T, Di] (softplus of ``dt_proj``), B and C
    [B, T, S]."""
    s, r, lin = cfg.mamba_d_state, dt_rank(cfg), mixer_linear(train)
    x_dbl = lin(p["x_proj"], x, quant=cfg.quant)
    dt, b_ssm, c_ssm = torch.split(x_dbl, [r, s, s], dim=-1)
    dt = softplus(lin(p["dt_proj"], dt, quant=cfg.quant))
    return dt, b_ssm, c_ssm


def _scan_step(a_log, d_resid):
    """The recurrence's body: (h [B, Di, S], (x_t, dt_t [B, Di], b_t, c_t
    [B, S])) → (h_t, y_t [B, Di]); ``h = exp(dt·A)·h + dt·x·B``, ``y =
    h·C + D·x``."""
    a = -torch.exp(a_log)

    def body(h, inp):
        x_t, dt_t, b_t, c_t = inp
        da = torch.exp(dt_t[..., None] * a)
        h = da * h + (dt_t * x_t)[..., None] * b_t[:, None, :]
        hc = torch.matmul(h.to(torch.float64),
                          c_t[:, :, None].to(torch.float64))[..., 0]
        return h, hc.to(torch.float32) + d_resid * x_t
    body.params = (a, d_resid)          # the tensors the body reads
    return body


def _gated_out(cfg, p, x, z, dt, b_ssm, c_ssm, h, dtype,
               train: bool = False):
    """Run the recurrence from ``h`` over T = x.shape[1] steps (chunks of
    64, recomputed in the backward when ``train``), gate with silu(z) and
    project out. → (out [B, T, D], the state after T)."""
    xs = tuple(a.transpose(0, 1) for a in (x, dt, b_ssm, c_ssm))
    step = _scan_step(p["A_log"], p["D"])
    h, ys = chunked_scan(stepwise(step), h, xs, remat=train,
                         params=step.params)
    y = ys.transpose(0, 1) * silu(z)
    return mixer_linear(train)(p["out_proj"], y.to(dtype), quant=cfg.quant), h


def mamba_forward(cfg, p, u, *, train: bool = False):
    """Prefill (or, with ``train``, the training forward) from zero
    states. u [B, T, D] → (y [B, T, D], {"ssm": h [B, Di, S], "conv": [B,
    ck − 1, Di]})."""
    b = u.shape[0]
    x, z = _ssm_inputs(cfg, p, u, train)
    x, conv_state = _causal_conv(x, p["conv_w"], p["conv_b"])
    x = silu(x)
    dt, b_ssm, c_ssm = _ssm_project(cfg, p, x, train)
    h0 = torch.zeros((b, cfg.d_inner, cfg.mamba_d_state),
                     dtype=torch.float32, device=u.device)
    out, h = _gated_out(cfg, p, x, z, dt, b_ssm, c_ssm, h0, u.dtype, train)
    return out, {"ssm": h, "conv": conv_state}


def mamba_decode_step(cfg, p, u, state):
    """One token. u [B, 1, D]; state {"ssm" [B, Di, S], "conv" [B, ck −
    1, Di]} → (y [B, 1, D], the new state)."""
    x, z = _ssm_inputs(cfg, p, u)
    x, conv_state = _causal_conv(x, p["conv_w"], p["conv_b"],
                                 state["conv"])
    x = silu(x)
    dt, b_ssm, c_ssm = _ssm_project(cfg, p, x)
    out, h = _gated_out(cfg, p, x, z, dt, b_ssm, c_ssm, state["ssm"],
                        u.dtype)
    return out, {"ssm": h, "conv": conv_state}


def mamba_state_shape(cfg, batch: int) -> dict:
    """One layer's decode state: name → (shape, dtype)."""
    return {"ssm": ((batch, cfg.d_inner, cfg.mamba_d_state), torch.float32),
            "conv": ((batch, cfg.mamba_conv - 1, cfg.d_inner),
                     torch.float32)}

