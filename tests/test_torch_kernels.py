"""The port's plain kernel versions held against the JAX reference.

Each plain PyTorch version (the CPU arm of ``repro_torch.kernels.ops``) is
compared with ``repro.kernels.ops.*(impl="ref")`` on the same numpy
inputs, and one small case each with the interpret-mode Pallas kernel
(prefill at ``bq=0`` only). f32 outputs agree to rtol = atol = 2e-5;
integer intermediates (barrier values, ranks, candidate sets) bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.lop import lop_features, pack_features
from repro.kernels import ops as jops
from repro.serving import lop_select as jsel
from repro_torch.kernels import ops as tops
from repro_torch.serving import lop_select as tsel

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def _ternary_node(rng, k, n, per_column=False):
    packed = rng.integers(0, 256, (k // 4, n)).astype(np.uint8)
    if per_column:
        scale = rng.uniform(0.01, 0.05, (1, n)).astype(np.float32)
    else:
        scale = np.full((1, 1), 0.03, np.float32)
    return packed, scale


# ---------------------------------------------------------------------------
# TINT projection and whole FFN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(1, 64, 48), (4, 128, 384), (33, 96, 40)])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("act", [None, "silu", "gelu"])
def test_qlinear_plain_vs_reference(m, k, n, bias, act):
    rng = np.random.default_rng(m * 1000 + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    packed, scale = _ternary_node(rng, k, n, per_column=bias)
    b = rng.standard_normal((n,)).astype(np.float32) * 0.1 if bias else None
    j = jops.qlinear_fused(jnp.asarray(x), jnp.asarray(packed),
                           jnp.asarray(scale),
                           None if b is None else jnp.asarray(b), act=act,
                           impl="ref")
    t = tops.qlinear_fused(_t(x), _t(packed), _t(scale),
                           None if b is None else _t(b), act=act)
    _close(t, j)


def test_qlinear_plain_vs_pallas():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 128)).astype(np.float32)
    packed, scale = _ternary_node(rng, 128, 96, per_column=True)
    j = jops.qlinear_fused(jnp.asarray(x), jnp.asarray(packed),
                           jnp.asarray(scale), act="silu", impl="pallas")
    t = tops.qlinear_fused(_t(x), _t(packed), _t(scale), act="silu")
    _close(t, j)


def test_qlinear_int_stage_bitwise():
    """The integer accumulator (before any float step) matches exactly."""
    from repro.kernels.ref import ternary_matmul_ref
    from repro_torch.core.ternary import unpack_ternary
    from repro_torch.kernels.ref import int_matmul
    rng = np.random.default_rng(4)
    xq = rng.integers(-127, 128, (5, 3200)).astype(np.int8)
    packed = rng.integers(0, 256, (800, 64)).astype(np.uint8)
    j = ternary_matmul_ref(jnp.asarray(xq), jnp.asarray(packed), 3200)
    t = int_matmul(_t(xq), unpack_ternary(_t(packed), 3200))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("gated,act", [(True, "silu"), (False, "gelu")])
@pytest.mark.parametrize("m", [1, 6])
def test_ffn_plain_vs_reference(gated, act, m):
    rng = np.random.default_rng(10 + m)
    d, f = 128, 256
    x = rng.standard_normal((m, d)).astype(np.float32)
    gu = rng.integers(0, 256, (d // 4, 2 * f if gated else f)).astype(np.uint8)
    gs = rng.uniform(0.01, 0.05, (1, gu.shape[1])).astype(np.float32)
    down = rng.integers(0, 256, (f // 4, d)).astype(np.uint8)
    ds = np.full((1, 1), 0.02, np.float32)
    args = (x, gu, gs, down, ds)
    j = jops.ffn_fused(*map(jnp.asarray, args), gated=gated, act=act,
                       impl="ref")
    t = tops.ffn_fused(*map(_t, args), gated=gated, act=act)
    _close(t, j)
    if m == 1 and gated:
        p = jops.ffn_fused(*map(jnp.asarray, args), gated=gated, act=act,
                           impl="pallas")
        _close(t, p)


def _tiled_barrier_integer_stages(x, packed, k):
    """The barrier (int8 values, scales) and the int32 accumulator of the
    plain version, bitwise the reference's own functions."""
    from repro.core.quantization import quantize as jquantize
    from repro.kernels.ref import ternary_matmul_ref
    from repro_torch.core.quantization import quantize
    from repro_torch.core.ternary import unpack_ternary
    from repro_torch.kernels.ref import int_matmul
    jq, tq = jquantize(jnp.asarray(x)), quantize(_t(x))
    np.testing.assert_array_equal(tq.values.numpy(), np.asarray(jq.values))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    np.testing.assert_array_equal(
        int_matmul(tq.values, unpack_ternary(_t(packed), k)).numpy(),
        np.asarray(ternary_matmul_ref(jq.values, jnp.asarray(packed), k)))


@pytest.mark.parametrize("bias,act", [(False, None), (True, "silu")])
def test_qlinear_plain_vs_tiled_barrier_reference(bias, act):
    """At k = 12,800 (above the 12,400 the CUDA projection was once capped
    at), the plain version — the function the uncapped kernel computes —
    against the reference kernel's bkq two-pass k-tiled barrier, run in
    interpret mode."""
    from repro.kernels.qlinear import fused_qlinear
    m, k, n = 8, 12800, 128
    rng = np.random.default_rng(12)
    x = rng.standard_normal((m, k)).astype(np.float32)
    packed, scale = _ternary_node(rng, k, n, per_column=True)
    b = rng.standard_normal((n,)).astype(np.float32) * 0.1 if bias else None
    j = fused_qlinear(jnp.asarray(x)[None], jnp.asarray(packed)[None],
                      jnp.asarray(scale)[None],
                      None if b is None else jnp.asarray(b)[None, None],
                      bm=m, bn=n, bkq=512, act=act, interpret=True)[0]
    t = tops.qlinear_fused(_t(x), _t(packed), _t(scale),
                           None if b is None else _t(b), act=act)
    _close(t, j)
    _tiled_barrier_integer_stages(x, packed, k)


@pytest.mark.parametrize("d,f", [(12800, 128), (256, 12800)])
def test_ffn_plain_vs_tiled_barrier_reference(d, f):
    """The whole FFN above the former 12,400 cap: d = 12,800 through the
    reference's bkq k-tiled barrier of x, and f = 12,800 through its
    barrier of the hidden row, run in interpret mode, against the plain
    version."""
    from repro.kernels.qlinear import fused_ffn
    m = 8
    rng = np.random.default_rng(d + f)
    x = rng.standard_normal((m, d)).astype(np.float32)
    gu, gs = _ternary_node(rng, d, 2 * f, per_column=True)
    down, ds = _ternary_node(rng, f, 128)
    ds = np.broadcast_to(ds, (1, 128)).copy()
    args = (x, gu, gs, down, ds)
    j = fused_ffn(*(jnp.asarray(a)[None] for a in args), bm=m, bf=128,
                  bn=128, bkq=512 if d > 4096 else 0, act="silu", gated=True,
                  interpret=True)[0]
    t = tops.ffn_fused(*map(_t, args), gated=True, act="silu")
    _close(t, j)
    _tiled_barrier_integer_stages(x, gu, d)


# ---------------------------------------------------------------------------
# Prefill attention
# ---------------------------------------------------------------------------

def _attn_inputs(rng, b, h, hkv, c, dh, m):
    qi = rng.integers(-127, 128, (b, h, c, dh)).astype(np.int8)
    qsc = (rng.random((b, h, c)) * 0.1 + 0.01).astype(np.float32)
    ki = rng.integers(-127, 128, (b, hkv, m, dh)).astype(np.int8)
    vi = rng.integers(-127, 128, (b, hkv, m, dh)).astype(np.int8)
    ks = (rng.random((b, hkv, m)) * 0.1 + 0.01).astype(np.float32)
    vs = (rng.random((b, hkv, m)) * 0.1 + 0.01).astype(np.float32)
    return qi, qsc, ki, vi, ks, vs


@pytest.mark.parametrize("dh", [32, 100])
@pytest.mark.parametrize("hkv,window,causal", [
    (4, 0, True), (2, 0, True), (2, 12, True), (2, 0, False)])
def test_prefill_plain_vs_reference(dh, hkv, window, causal):
    rng = np.random.default_rng(dh + hkv + window)
    b, h, c, m = 2, 4, 8, 64
    arrs = _attn_inputs(rng, b, h, hkv, c, dh, m)
    kv_len = np.asarray([40, 0], np.int32)           # lane 1 empty
    kw = dict(q_offset=32, causal=causal, window=window)
    j = jops.prefill_attention(*map(jnp.asarray, arrs), jnp.asarray(kv_len),
                               impl="ref", **kw)
    t = tops.prefill_attention(*map(_t, arrs), _t(kv_len), **kw)
    _close(t, j)
    assert not t[1].any()                            # kv_len 0 → exact zero


def test_prefill_plain_vs_pallas():
    rng = np.random.default_rng(5)
    arrs = _attn_inputs(rng, 1, 4, 2, 8, 32, 64)
    kv_len = np.asarray([40], np.int32)
    j = jops.prefill_attention(*map(jnp.asarray, arrs), jnp.asarray(kv_len),
                               q_offset=32, impl="pallas")
    t = tops.prefill_attention(*map(_t, arrs), _t(kv_len), q_offset=32)
    _close(t, j)


@pytest.mark.parametrize("dh", [32, 100])
def test_prefill_chunked_bitwise_whole(dh):
    """Chunked rows over the same capacity-padded cache equal whole rows."""
    rng = np.random.default_rng(6)
    s, c, m = 24, 8, 64
    qi, qsc, ki, vi, ks, vs = map(_t, _attn_inputs(rng, 1, 2, 2, s, dh, m))
    whole = tops.prefill_attention(qi, qsc, ki, vi, ks, vs,
                                   torch.tensor([s], dtype=torch.int32))
    for start in range(0, s, c):
        part = tops.prefill_attention(
            qi[:, :, start:start + c], qsc[:, :, start:start + c], ki, vi, ks,
            vs, torch.tensor([start + c], dtype=torch.int32), q_offset=start)
        assert torch.equal(part, whole[:, :, start:start + c])


# ---------------------------------------------------------------------------
# Decode attention
# ---------------------------------------------------------------------------

def _decode_inputs(rng, b, h, hkv, m, dh):
    qi = rng.integers(-60, 61, (b, h, dh)).astype(np.int8)
    qs = rng.uniform(0.005, 0.02, (b, h, 1)).astype(np.float32)
    k = rng.integers(-60, 61, (b, hkv, m, dh)).astype(np.int8)
    v = rng.integers(-60, 61, (b, hkv, m, dh)).astype(np.int8)
    ks = rng.uniform(0.005, 0.02, (b, hkv, m)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, (b, hkv, m)).astype(np.float32)
    feat = np.asarray(pack_features(lop_features(jnp.asarray(k))))
    return qi, qs, k, v, ks, vs, feat


DECODE_MODES = [
    dict(use_lop=True), dict(use_lop=True, window=48),
    dict(use_lop=True, shared_select=True), dict(use_lop=False),
    dict(use_lop=False, window=48),
    dict(use_lop=True, return_stats=True),
    dict(use_lop=False, return_stats=True),
    dict(use_lop=True, pos_offset=64, return_stats=True),
]


@pytest.mark.parametrize("dh,h,hkv", [(32, 8, 2), (100, 4, 4)])
@pytest.mark.parametrize("mode", DECODE_MODES,
                         ids=lambda d: "-".join(f"{k}={v}" for k, v in d.items()))
def test_decode_plain_vs_reference(dh, h, hkv, mode):
    rng = np.random.default_rng(dh * 7 + h)
    b, m = 3, 128
    arrs = _decode_inputs(rng, b, h, hkv, m, dh)
    new_len = np.asarray([100, 0, 37], np.int32)     # lane 1 retired
    kw = dict(block=16, k_keep=2, **mode)
    j = jops.decode_attention(*map(jnp.asarray, arrs), jnp.asarray(new_len),
                              impl="ref", **kw)
    t = tops.decode_attention(*map(_t, arrs), _t(new_len), **kw)
    if mode.get("return_stats"):
        for a, b_ in zip(t, j):
            _close(a, b_)
        t = t[0]
    else:
        _close(t, j)
    assert not t[1].any()                            # new_len 0 → exact zero


def test_decode_plain_vs_pallas():
    rng = np.random.default_rng(8)
    arrs = _decode_inputs(rng, 2, 4, 4, 128, 32)
    new_len = np.asarray([100, 57], np.int32)
    kw = dict(block=32, k_keep=2)
    j = jops.decode_attention(*map(jnp.asarray, arrs), jnp.asarray(new_len),
                              impl="pallas", **kw)
    t = tops.decode_attention(*map(_t, arrs), _t(new_len), **kw)
    _close(t, j)


@pytest.mark.parametrize("window", [0, 40])
def test_select_blocks_bitwise(window):
    rng = np.random.default_rng(9)
    scores = rng.integers(-30000, 30000, (3, 2, 2, 128)).astype(np.int32)
    scores[0, 0, 0, :64] = 123                         # ties
    new_len = np.asarray([128, 0, 50], np.int32)
    idx_j, gt_j = jsel.select_blocks(jnp.asarray(scores),
                                     jnp.asarray(new_len), block=16,
                                     k_keep=3, window=window)
    idx_t, gt_t = tsel.select_blocks(_t(scores), _t(new_len), block=16,
                                     k_keep=3, window=window)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(gt_t.numpy(), np.asarray(gt_j))
