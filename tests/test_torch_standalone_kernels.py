"""The four standalone kernels of the port (TINT GEMM, LOP screen, flash
prefill, block-sparse decode) and the core numerics under them, held
against the JAX reference on the same numpy inputs.

Each plain version (the CPU arm of ``repro_torch.kernels.ops``) is
compared with the reference's interpret-mode Pallas kernel at the shapes
of its own kernel tests, and with its ``impl="ref"`` arm at bitnet-3b's
head_dim 100 and k = 3200 / 8640 (shapes the TPU kernels' block asserts
refuse). Tolerances: integer results bitwise; f32 results atol = 1e-4
(the reference's kernel-test tolerance), rtol 0.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lop as jlop
from repro.core import quantization as jquant
from repro.core import ternary as jtern
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core import lop as tlop
from repro_torch.core import quantization as tquant
from repro_torch.core import ternary as ttern
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops

torch.set_num_threads(1)

ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=ATOL)


def _equal(t, j):
    j = np.asarray(j)
    assert t.numpy().dtype == j.dtype
    np.testing.assert_array_equal(t.numpy(), j)


def _tw(rng, k, n, per_channel=False):
    """A reference TernaryWeight and its port counterpart, bitwise."""
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.02
    jw = jtern.make_ternary_weight(jnp.asarray(w), per_channel=per_channel)
    tw = convert.ternary_weight_from_numpy(np.asarray(jw.packed),
                                           np.asarray(jw.scale), jw.shape,
                                           "cpu")
    return jw, tw


# ---------------------------------------------------------------------------
# the C interface: every ctypes signature matches its CUDA declaration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("source", _build.SOURCES)
def test_c_signatures_match_sources(source):
    """ctypes passes what ``SIGNATURES`` says, whatever the C function
    takes, so a miscounted argument only shows on the card."""
    import ctypes
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float,
             "size_t": ctypes.c_size_t}
    text = (_build.CSRC / f"{source}.cu").read_text()
    decls = {name: (ret, [a.strip() for a in args.split(",") if a.strip()])
             for ret, name, args in re.findall(
                 r"^(int|size_t)\s+(repro_\w+)\(([^)]*)\)", text, re.M)}
    assert sorted(decls) == sorted(_build.SIGNATURES[source])
    for name, (argtypes, restype) in _build.SIGNATURES[source].items():
        ret, args = decls[name]
        assert restype is kinds[ret], name
        want = [ctypes.c_void_p if "*" in a else kinds[a.split()[0]]
                for a in args]
        assert argtypes == want, name


@pytest.mark.parametrize("header", sorted(
    p.name for p in _build.CSRC.glob("*.cuh")))
def test_build_hash_covers_every_header(header, tmp_path, monkeypatch):
    """A one-byte edit to any shared header names a new library for every
    source, so a stale build is never loaded."""
    import shutil
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {s: _build._lib_path(s) for s in _build.SOURCES}
    assert before == {s: _build._lib_path(s) for s in _build.SOURCES}
    path = csrc / header
    data = bytearray(path.read_bytes())
    data[-1] ^= 1
    path.write_bytes(bytes(data))
    after = {s: _build._lib_path(s) for s in _build.SOURCES}
    assert all(after[s] != before[s] for s in _build.SOURCES)


# ---------------------------------------------------------------------------
# core: ternary weights, int8 GEMM, softmax stats, LOP scores and traffic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("per_channel", [False, True])
def test_make_ternary_weight_bitwise(per_channel):
    rng = np.random.default_rng(1)
    w = rng.standard_normal((64, 24)).astype(np.float32) * 0.02
    jw = jtern.make_ternary_weight(jnp.asarray(w), per_channel=per_channel)
    tw = ttern.make_ternary_weight(_t(w), per_channel=per_channel)
    _equal(tw.packed, jw.packed)
    assert tw.shape == tuple(jw.shape)
    assert tuple(tw.scale.shape) == tuple(jw.scale.shape)
    # γ is a mean: its last bit follows the summation order
    np.testing.assert_allclose(tw.scale.numpy(), np.asarray(jw.scale),
                               rtol=1e-6)


@pytest.mark.parametrize("per_channel", [False, True])
def test_bitlinear_through_converter(per_channel):
    rng = np.random.default_rng(2)
    jw, tw = _tw(rng, 128, 40, per_channel)
    _equal(tw.packed, jw.packed)
    _equal(tw.scale, jw.scale)
    x = rng.standard_normal((5, 128)).astype(np.float32)
    j = jtern.bitlinear_ref(jnp.asarray(x), jw)
    t = ttern.bitlinear_ref(_t(x), tw)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    j = jtern.bitlinear_infer(jquant.quantize(jnp.asarray(x)), jw)
    t = ttern.bitlinear_infer(tquant.quantize(_t(x)), tw)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("fmt", ["bf16", "int8", "ternary_packed"])
def test_memory_footprint_bytes(fmt):
    for shape in ((3200, 9600), (8640, 3200)):
        assert ttern.memory_footprint_bytes(shape, fmt) == \
            jtern.memory_footprint_bytes(shape, fmt)


def test_int8_matmul_and_softmax_stats():
    rng = np.random.default_rng(3)
    xq = jquant.quantize(jnp.asarray(rng.standard_normal((4, 96)),
                                     jnp.float32))
    txq = tquant.QuantizedTensor(_t(xq.values), _t(xq.scale))
    w = rng.integers(-1, 2, (96, 16)).astype(np.int8)
    ws = rng.uniform(0.01, 0.05, (1, 16)).astype(np.float32)
    j = jquant.int8_matmul(xq, jnp.asarray(w), jnp.asarray(ws))
    t = tquant.int8_matmul(txq, _t(w), _t(ws))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 4
    jm, js = jquant.online_softmax_stats(jnp.asarray(logits))
    tm, ts = tquant.online_softmax_stats(_t(logits))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)


@pytest.mark.parametrize("shape_q,shape_k", [((100,), (1664, 100)),
                                             ((2, 3, 32), (2, 3, 64, 32))])
def test_lop_scores_bitwise(shape_q, shape_k):
    rng = np.random.default_rng(4)
    q = rng.integers(-127, 128, shape_q).astype(np.int8)
    k = rng.integers(-127, 128, shape_k).astype(np.int8)
    _equal(tlop.lop_scores(_t(q), _t(k)),
           jlop.lop_scores(jnp.asarray(q), jnp.asarray(k)))


def test_exact_topk_and_traffic():
    rng = np.random.default_rng(5)
    s = rng.integers(-20, 20, (6, 40)).astype(np.int32)   # many ties
    _equal(tlop.exact_topk(_t(s), 5), jlop.exact_topk(jnp.asarray(s), 5))
    for m, d, k in ((1664, 100, 256), (64, 32, 8)):
        for kw in (dict(), dict(with_lop=False),
                   dict(packed_features=False)):
            assert tlop.kv_traffic_bytes(m, d, k, **kw) == \
                jlop.kv_traffic_bytes(m, d, k, **kw)


# ---------------------------------------------------------------------------
# #7 ternary_matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(8, 128, 128), (1, 256, 512),
                                   (2, 512, 256)])
def test_ternary_matmul_vs_pallas(m, k, n):
    rng = np.random.default_rng(m + k + n)
    x = rng.integers(-127, 128, (m, k)).astype(np.int8)
    jw, tw = _tw(rng, k, n)
    j = jops.ternary_matmul(jnp.asarray(x), jw, impl="pallas")
    _equal(tops.ternary_matmul(_t(x), tw), j)


@pytest.mark.parametrize("m,k,n", [(4, 3200, 64), (3, 8640, 40),
                                   (2, 100, 12), (2, 16384, 24)])
def test_ternary_matmul_vs_ref_bitnet_k(m, k, n):
    """k = 3200 / 8640 (bitnet-3b's projections), a k that is no multiple
    of 8, and a k above the CUDA kernel's former 13,952 cap: the TPU
    kernel cannot take them, its ref arm can."""
    rng = np.random.default_rng(k + n)
    x = rng.integers(-127, 128, (m, k)).astype(np.int8)
    jw, tw = _tw(rng, k, n)
    _equal(tops.ternary_matmul(_t(x), tw),
           jops.ternary_matmul(jnp.asarray(x), jw, impl="ref"))


def test_ternary_matmul_leading_dims():
    rng = np.random.default_rng(6)
    x = rng.integers(-50, 51, (2, 3, 256)).astype(np.int8)
    jw, tw = _tw(rng, 256, 128)
    t = tops.ternary_matmul(_t(x), tw)
    assert t.shape == (2, 3, 128)
    _equal(t, jops.ternary_matmul(jnp.asarray(x), jw, impl="pallas"))


# ---------------------------------------------------------------------------
# #6 lop_scores (the LOP screen)
# ---------------------------------------------------------------------------

def _feat(rng, *shape):
    kc = rng.integers(-127, 128, shape).astype(np.int8)
    return np.asarray(jlop.pack_features(jlop.lop_features(jnp.asarray(kc))))


@pytest.mark.parametrize("g,m,d", [(12, 1024, 128), (1, 512, 64)])
def test_lop_screen_vs_pallas(g, m, d):
    rng = np.random.default_rng(g + m)
    q = rng.integers(-127, 128, (g, d)).astype(np.int8)
    feat = _feat(rng, m, d)
    j = jops.lop_screen(jnp.asarray(q), jnp.asarray(feat), impl="pallas")
    _equal(tops.lop_screen(_t(q), _t(feat)), j)


def test_lop_screen_vs_ref_dh100():
    """head_dim 100 (50-byte feature rows) at the 1664-token capacity,
    which the TPU kernel's 512-key block refuses."""
    rng = np.random.default_rng(7)
    q = rng.integers(-127, 128, (3, 100)).astype(np.int8)
    feat = _feat(rng, 1664, 100)
    _equal(tops.lop_screen(_t(q), _t(feat)),
           jops.lop_screen(jnp.asarray(q), jnp.asarray(feat), impl="ref"))


def test_lop_screen_batched_equals_vmap():
    """[B, Hkv, G, d] × [B, Hkv, M, d/2] in one call == the reference's
    vmap over (B, Hkv), as the Fig. 8 path screens."""
    rng = np.random.default_rng(8)
    b, hkv, g, m, d = 2, 3, 2, 200, 100
    q = rng.integers(-127, 128, (b, hkv, g, d)).astype(np.int8)
    feat = _feat(rng, b, hkv, m, d)
    screen = jax.vmap(jax.vmap(lambda q_, f_: jops.lop_screen(q_, f_,
                                                              impl="ref")))
    _equal(tops.lop_screen(_t(q), _t(feat)),
           screen(jnp.asarray(q), jnp.asarray(feat)))


# ---------------------------------------------------------------------------
# #8 int8_flash_prefill
# ---------------------------------------------------------------------------

def _prefill_inputs(rng, s, d):
    arrs = [rng.integers(-60, 61, (s, d)).astype(np.int8) for _ in range(3)]
    arrs += [rng.uniform(0.005, 0.02, (s, 1)).astype(np.float32)
             for _ in range(3)]
    return arrs


@pytest.mark.parametrize("s,d,causal,window", [
    (256, 64, True, 0), (256, 128, False, 0),
    (512, 64, True, 128)])          # SWA rows whose first tile is all masked
def test_flash_prefill_vs_pallas(s, d, causal, window):
    rng = np.random.default_rng(s + d + window)
    arrs = _prefill_inputs(rng, s, d)
    kw = dict(softmax_scale=1.0 / np.sqrt(d), causal=causal, window=window)
    j = jops.flash_prefill(*map(jnp.asarray, arrs), impl="pallas", **kw)
    _close(tops.flash_prefill(*map(_t, arrs), **kw), j)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 100),
                                           (False, 0)])
def test_flash_prefill_vs_ref_dh100(causal, window):
    rng = np.random.default_rng(9 + window)
    s, d = 300, 100
    arrs = _prefill_inputs(rng, s, d)
    kw = dict(softmax_scale=d ** -0.5, causal=causal, window=window)
    j = jops.flash_prefill(*map(jnp.asarray, arrs), impl="ref", **kw)
    _close(tops.flash_prefill(*map(_t, arrs), **kw), j)


# ---------------------------------------------------------------------------
# #9 sparse_decode_attention
# ---------------------------------------------------------------------------

def _decode_inputs(rng, g, m, d):
    return [rng.integers(-60, 61, (g, d)).astype(np.int8),
            rng.integers(-60, 61, (m, d)).astype(np.int8),
            rng.integers(-60, 61, (m, d)).astype(np.int8),
            rng.uniform(0.005, 0.02, (g, 1)).astype(np.float32),
            rng.uniform(0.005, 0.02, (m, 1)).astype(np.float32),
            rng.uniform(0.005, 0.02, (m, 1)).astype(np.float32)]


def _gates(rng, nb, block, n_off=1):
    gate = np.ones(nb, np.int32)
    gate[nb - n_off:] = 0
    end = rng.integers(1, block + 1, nb).astype(np.int32)
    start = np.minimum(rng.integers(0, block, nb), end - 1).astype(np.int32)
    return np.concatenate([gate, end, start]).astype(np.int32)


def _sparse(impl_or_torch, q, kc, vc, qs, ks, vs, bidx, gt, **kw):
    if impl_or_torch == "torch":
        return tops.sparse_decode(*map(_t, (q, kc, vc, qs, ks, vs, bidx, gt)),
                                  **kw)
    return jops.sparse_decode(*map(jnp.asarray, (q, kc, vc, qs, ks, vs, bidx,
                                                 gt)), impl=impl_or_torch,
                              **kw)


@pytest.mark.parametrize("g,nb,block", [(6, 4, 128), (1, 2, 64),
                                        (8, 8, 32)])
def test_sparse_decode_vs_pallas(g, nb, block):
    rng = np.random.default_rng(g * 100 + nb)
    m, d = 16 * block, 64
    arrs = _decode_inputs(rng, g, m, d)
    bidx = rng.choice(16, nb, replace=False).astype(np.int32)
    gt = _gates(rng, nb, block)
    kw = dict(block=block, softmax_scale=1.0 / np.sqrt(d))
    _close(_sparse("torch", *arrs, bidx, gt, **kw),
           _sparse("pallas", *arrs, bidx, gt, **kw))


def test_sparse_decode_vs_ref_dh100():
    """Live lanes only: every call has a gated block with live tokens."""
    rng = np.random.default_rng(10)
    g, m, d, block, nb = 2, 1664, 100, 128, 3
    arrs = _decode_inputs(rng, g, m, d)
    bidx = np.array([12, 0, 5], np.int32)
    gt = _gates(rng, nb, block)
    kw = dict(block=block, softmax_scale=d ** -0.5)
    _close(_sparse("torch", *arrs, bidx, gt, **kw),
           _sparse("ref", *arrs, bidx, gt, **kw))


def test_sparse_decode_empty_lane_is_zero():
    """Every gate 0 (a lane select_blocks left with no live block): the
    TPU kernel, and so the port, emits exact zero; the reference oracle's
    one-pass softmax over an all-masked row gives the mean of the
    gathered V instead (recorded in ROADMAP §3 as a reference-side
    difference)."""
    rng = np.random.default_rng(11)
    g, block, nb = 4, 32, 2
    m, d = 8 * block, 64
    arrs = _decode_inputs(rng, g, m, d)
    bidx = np.array([3, 1], np.int32)
    gt = _gates(rng, nb, block, n_off=nb)
    kw = dict(block=block, softmax_scale=1.0 / np.sqrt(d))
    t = _sparse("torch", *arrs, bidx, gt, **kw)
    j = _sparse("pallas", *arrs, bidx, gt, **kw)
    assert not t.any()
    _equal(t, j)
    assert np.asarray(_sparse("ref", *arrs, bidx, gt, **kw)).any()


@pytest.mark.parametrize("case", ["empty_before_live", "only_empty"])
def test_sparse_decode_masked_intervals_vs_pallas(case):
    """Gated blocks whose [start, end) is empty, held against the
    interpret-mode Pallas kernel: masked tokens weigh exp(−1e30 − m'),
    1 while no live token has been folded. Before a live block that
    weight is wiped (α = 0); where no gated block holds a live token the
    call gives the mean of the gathered, dequantized V, not zero."""
    rng = np.random.default_rng(13 if case == "only_empty" else 14)
    g, block, nb = 2, 32, 3
    m, d = 8 * block, 64
    arrs = _decode_inputs(rng, g, m, d)
    bidx = np.array([6, 2, 4], np.int32)
    gate = np.array([1, 1, 0], np.int32)
    if case == "empty_before_live":
        start = np.array([5, 3, 0], np.int32)
        end = np.array([5, 29, 32], np.int32)
    else:
        start = np.array([5, 20, 0], np.int32)
        end = np.array([5, 11, 32], np.int32)
    gt = np.concatenate([gate, end, start]).astype(np.int32)
    kw = dict(block=block, softmax_scale=1.0 / np.sqrt(d))
    t = _sparse("torch", *arrs, bidx, gt, **kw)
    _close(t, _sparse("pallas", *arrs, bidx, gt, **kw))
    if case == "only_empty":
        vc, vs = arrs[2], arrs[5]
        rows = np.concatenate([np.arange(b * block, (b + 1) * block)
                               for b in bidx[gate > 0]])
        mean = (vc[rows].astype(np.float64) * vs[rows]).mean(0)
        _close(t, np.broadcast_to(mean, (g, d)))


def test_sparse_decode_batched_equals_vmap():
    """[B, Hkv, G] lanes over [B, Hkv] caches in one call == the
    reference's vmap over (B, Hkv, G) with the cache broadcast over G, as
    in the Fig. 8 path; one lane is empty (exact zero on both sides)."""
    rng = np.random.default_rng(12)
    b, hkv, g, m, d, block, nb = 2, 2, 3, 256, 100, 64, 2
    q = rng.integers(-60, 61, (b, hkv, g, 1, d)).astype(np.int8)
    qs = rng.uniform(0.005, 0.02, (b, hkv, g, 1, 1)).astype(np.float32)
    kc = rng.integers(-60, 61, (b, hkv, m, d)).astype(np.int8)
    vc = rng.integers(-60, 61, (b, hkv, m, d)).astype(np.int8)
    ks = rng.uniform(0.005, 0.02, (b, hkv, m, 1)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, (b, hkv, m, 1)).astype(np.float32)
    bidx = rng.integers(0, m // block, (b, hkv, g, nb)).astype(np.int32)
    gt = np.stack([_gates(rng, nb, block, n_off=1)
                   for _ in range(b * hkv * g)]).reshape(b, hkv, g, 3 * nb)
    gt[1, 0, 2, :nb] = 0                                 # an empty lane
    kw = dict(block=block, softmax_scale=d ** -0.5)

    def one(qv, qsv, kv, vv, ksv, vsv, bi, gtv):
        return jops.sparse_decode(qv, kv, vv, qsv, ksv, vsv, bi, gtv,
                                  impl="pallas", **kw)
    per_g = jax.vmap(one, in_axes=(0, 0, None, None, None, None, 0, 0))
    j = jax.vmap(jax.vmap(per_g))(*map(jnp.asarray, (q, qs, kc, vc, ks, vs,
                                                     bidx, gt)))
    t = tops.sparse_decode(*map(_t, (q, kc, vc, qs, ks, vs, bidx, gt)), **kw)
    assert t.shape == (b, hkv, g, 1, d)
    _close(t, j)
    assert not t[1, 0, 2].any()
