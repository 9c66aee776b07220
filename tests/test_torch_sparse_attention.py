"""The paper's predictive sparse attention in the port, held against the
JAX reference: the plain system view (screen → select → gather → exact)
and the per-head pipeline the Fig. 8 ablation runs through the public
kernel API — ``lop_screen`` over every (batch, kv-head) lane, then
``select_blocks``, then ``sparse_decode`` over every (batch, kv-head,
group) lane — composed from each package's public ops exactly as
``benchmarks/fig8_lop.py`` composes them, on ``bitnet-3b-reduced``.

Tolerances: candidate sets bitwise; f32 outputs atol = 1e-4 (the
reference's kernel-test tolerance), rtol 0.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.bitnet_3b import REDUCED as JAX_REDUCED
from repro.core import lop as jlop
from repro.core import sparse_attention as jsa
from repro.kernels import ops as jops
from repro.serving import lop_select as jsel
from repro_torch.configs import get_config as tget_config
from repro_torch.core import lop as tlop
from repro_torch.core import sparse_attention as tsa
from repro_torch.kernels import ops as tops
from repro_torch.serving import lop_select as tsel

torch.set_num_threads(1)

ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=ATOL)


def _cache(rng, b, h, hkv, m, d):
    return dict(
        q=rng.integers(-80, 81, (b, h, d)).astype(np.int8),
        qsc=rng.uniform(0.005, 0.02, (b, h, 1)).astype(np.float32),
        k=rng.integers(-80, 81, (b, hkv, m, d)).astype(np.int8),
        v=rng.integers(-80, 81, (b, hkv, m, d)).astype(np.int8),
        k_scale=rng.uniform(0.005, 0.02, (b, hkv, m)).astype(np.float32),
        v_scale=rng.uniform(0.005, 0.02, (b, hkv, m)).astype(np.float32))


# ---------------------------------------------------------------------------
# the plain system view
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,hkv,m,d,block,k_blocks", [
    (2, 4, 2, 128, 32, 32, 2), (2, 2, 2, 256, 100, 64, 1)])
def test_predictive_sparse_attention_vs_reference(b, h, hkv, m, d, block,
                                                  k_blocks):
    rng = np.random.default_rng(m + d)
    c = _cache(rng, b, h, hkv, m, d)
    feat = np.asarray(jlop.lop_features(jnp.asarray(c["k"])))
    lens = rng.integers(1, m + 1, b)
    valid = np.arange(m)[None, :] < lens[:, None]
    kw = dict(k_blocks=k_blocks, block=block)
    j = jsa.predictive_sparse_attention(
        *map(jnp.asarray, (c["q"], c["k"], c["v"], feat, valid)), **kw)
    t = tsa.predictive_sparse_attention(
        *map(_t, (c["q"], c["k"], c["v"], feat, valid)), **kw)
    _close(t, j)


def test_dense_reference_attention_vs_reference():
    rng = np.random.default_rng(13)
    b, h, hkv, m, d = 2, 4, 2, 96, 100
    c = _cache(rng, b, h, hkv, m, d)
    valid = np.arange(m)[None, :] < np.array([90, 7])[:, None]
    j = jsa.dense_reference_attention(
        *map(jnp.asarray, (c["q"], c["k"], c["v"], valid)))
    t = tsa.dense_reference_attention(*map(_t, (c["q"], c["k"], c["v"],
                                                valid)))
    _close(t, j)


def test_predictive_equals_dense_when_every_block_kept():
    rng = np.random.default_rng(14)
    b, h, hkv, m, d, block = 2, 4, 2, 128, 32, 32
    c = _cache(rng, b, h, hkv, m, d)
    feat = tlop.lop_features(_t(c["k"]))
    valid = torch.arange(m)[None, :] < torch.tensor([128, 50])[:, None]
    args = (_t(c["q"]), _t(c["k"]), _t(c["v"]))
    sparse = tsa.predictive_sparse_attention(*args, feat, valid,
                                             k_blocks=m // block, block=block)
    dense = tsa.dense_reference_attention(*args, valid)
    torch.testing.assert_close(sparse, dense, rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# the per-head pipeline of the Fig. 8 ablation
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnums=(0, 5))
def _jax_per_head(cfg, qi, qsc, cl, new_len, impl):
    """The reference's per-head dispatch (fig8_lop.py:_legacy_vmap_decode)."""
    b, h, dh = qi.shape
    hkv, m = cl["k"].shape[1], cl["k"].shape[2]
    g = h // hkv
    block = cfg.lop_block
    k_keep = jsel.k_keep_blocks(cfg, m)
    qg = qi.reshape(b, hkv, g, dh)
    screen = jax.vmap(jax.vmap(lambda q_, f_: jops.lop_screen(q_, f_,
                                                              impl=impl)))
    scores = screen(qg, cl["feat"])                       # [B, Hkv, G, M]
    idx, gate_tokens = jsel.select_blocks(scores, new_len, block=block,
                                          k_keep=k_keep, window=0)

    def one(qv, qs, kc, vc, ks, vs, bi, gt):
        return jops.sparse_decode(qv[None], kc, vc, qs.reshape(1, 1),
                                  ks[:, None], vs[:, None], bi, gt,
                                  block=block, softmax_scale=dh ** -0.5,
                                  impl=impl)[0]

    per_g = jax.vmap(one, in_axes=(0, 0, None, None, None, None, 0, 0))
    out = jax.vmap(jax.vmap(per_g))(qg, qsc.reshape(b, hkv, g), cl["k"],
                                    cl["v"], cl["k_scale"], cl["v_scale"],
                                    idx, gate_tokens)
    return out.reshape(b, h, dh), idx, gate_tokens


def _torch_per_head(cfg, qi, qsc, cl, new_len):
    """The same pipeline through the port's public ops: one lop_screen
    over every (B, Hkv) lane, select_blocks, one sparse_decode over every
    (B, Hkv, G) lane."""
    b, h, dh = qi.shape
    hkv, m = cl["k"].shape[1], cl["k"].shape[2]
    g = h // hkv
    block = cfg.lop_block
    qg = qi.reshape(b, hkv, g, dh)
    scores = tops.lop_screen(qg, cl["feat"])             # [B, Hkv, G, M]
    idx, gate_tokens = tsel.select_blocks(
        scores, new_len, block=block, k_keep=tsel.k_keep_blocks(cfg, m),
        window=0)
    out = tops.sparse_decode(
        qg[..., None, :], cl["k"], cl["v"], qsc.reshape(b, hkv, g, 1, 1),
        cl["k_scale"][..., None], cl["v_scale"][..., None], idx, gate_tokens,
        block=block, softmax_scale=dh ** -0.5)           # [B, Hkv, G, 1, dh]
    return out.reshape(b, h, dh), idx, gate_tokens


@pytest.mark.parametrize("m,new_len,impl", [
    (384, [380, 1, 200, 300], "ref"),
    (128, [128, 40, 1, 90], "pallas")])
def test_per_head_pipeline_vs_reference(m, new_len, impl):
    cfg = JAX_REDUCED
    tcfg = tget_config("bitnet-3b-reduced")
    rng = np.random.default_rng(m)
    c = _cache(rng, 4, cfg.n_heads, cfg.n_kv_heads, m, cfg.hd)
    c["feat"] = np.asarray(jlop.pack_features(jlop.lop_features(
        jnp.asarray(c["k"]))))
    nl = np.asarray(new_len, np.int32)
    cl = {k_: c[k_] for k_ in ("k", "v", "k_scale", "v_scale", "feat")}
    j, j_idx, j_gt = _jax_per_head(
        cfg, jnp.asarray(c["q"]), jnp.asarray(c["qsc"]),
        {k_: jnp.asarray(v_) for k_, v_ in cl.items()}, jnp.asarray(nl),
        impl)
    t, t_idx, t_gt = _torch_per_head(
        tcfg, _t(c["q"]), _t(c["qsc"]), {k_: _t(v_) for k_, v_ in cl.items()},
        _t(nl))
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_gt.numpy(), np.asarray(j_gt))
    _close(t, j)
    # the same function as the fused LOP decode kernel's plain version
    fused = tops.decode_attention(
        _t(c["q"]), _t(c["qsc"]), *(_t(cl[k_]) for k_ in
                                    ("k", "v", "k_scale", "v_scale", "feat")),
        _t(nl), block=tcfg.lop_block, k_keep=tsel.k_keep_blocks(tcfg, m))
    torch.testing.assert_close(t, fused, rtol=0, atol=ATOL)
