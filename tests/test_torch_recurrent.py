"""The port's recurrent model modules held against the JAX reference on
the CPU, on ``rwkv6-1.6b-reduced`` (3 layers, d 96, 4 heads of 24, d_ff
192) and ``jamba-1.5-large-398b-reduced`` (2 superblocks of 4 sublayers,
d 128, Di 256, S 16, dt_rank 8), with the reference's served weights
carried over by :mod:`repro_torch.convert`:

  * ``chunked_scan`` against the reference's, T below, at and above the
    chunk and with a ragged tail, bitwise;
  * ``rwkv_time_mix`` (its projections, the wkv recurrence — chunked, and
    bitwise a step-at-a-time loop over T below, at and above its chunk —
    the group norm) and
    ``rwkv_channel_mix`` at a prompt's T and at T = 1 from a
    random state, ``_causal_conv`` bitwise, ``mamba_forward`` and
    ``mamba_decode_step``: outputs and states within rtol = atol = 2e-5,
    the int8 barrier values in front of the out projections bitwise but
    for 1-ulp knife-edges;
  * reduced jamba's ``dt_proj`` (k 8, too small to pack) served in f32
    through the QAT BitLinear forward, within 2e-5, and softplus as
    ``jax.nn.softplus`` forms it;
  * the ssm and hybrid serving trees leaf for leaf (paths, dtypes, shapes,
    codes bitwise, γ within 1e-6) and bitwise through the converter; the
    port's master trees with the reference's paths and shapes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.jamba_1_5_large_398b import REDUCED as JJAMBA
from repro.configs.rwkv6_1_6b import REDUCED as JRWKV
from repro.core.quantization import quantize as jquant
from repro.models import mamba as jmamba
from repro.models import rwkv6 as jrwkv
from repro.models.layers import linear_apply as jlinear_apply
from repro.models.scan_utils import chunked_scan as jchunked_scan
from repro.models.transformer import init_params as jinit
from repro.serving.quantize import quantize_params as jquantize
from repro_torch.configs import get_config
from repro_torch.convert import from_numpy_tree
from repro_torch.core.quantization import absmax_scale, quantize
from repro_torch.models import mamba, rwkv6
from repro_torch.models.layers import linear_apply
from repro_torch.models.scan_utils import chunked_scan, stepwise
from repro_torch.models.transformer import init_params, layer_slice
from repro_torch.serving.quantize import quantize_params

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)
RWKV = get_config("rwkv6-1.6b-reduced")
JAMBA = get_config("jamba-1.5-large-398b-reduced")
PAIRS = {"rwkv6": (JRWKV, RWKV), "jamba": (JJAMBA, JAMBA)}


def _flat(tree) -> dict:
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def masters():
    """The reference's master trees, drawn under ``jax.jit`` (one compile
    instead of thousands of eager dispatches)."""
    return {name: jax.jit(lambda k, c=jcfg: jinit(c, k)[0])(
        jax.random.PRNGKey(0)) for name, (jcfg, _) in PAIRS.items()}


@pytest.fixture(scope="module")
def served(masters):
    """name → (the reference's serving tree, the same converted)."""
    out = {}
    for name, (jcfg, _) in PAIRS.items():
        jqp = jax.jit(lambda p, c=jcfg: jquantize(c, p))(masters[name])
        out[name] = (jqp, from_numpy_tree(jax.tree.map(np.asarray, jqp),
                                          "cpu"))
    return out


def _near_ties(ours, ref, f32):
    """Where the int8 tensors differ, the port's scaled f32 value must lie
    within 1e-5 of a rounding boundary (a 1-ulp knife-edge). → their
    count."""
    apart = np.nonzero(ours != ref)
    frac = np.abs(np.abs(f32[apart]) % 1.0 - 0.5)
    assert (frac <= 1e-5).all(), f32[apart]
    return len(apart[0])


def _ys(body, carry, xs):
    """The reference's ``chunked_scan`` of ``body``, compiled once. → the
    stacked y."""
    return jax.jit(lambda c, x: jchunked_scan(body, c, x)[1])(carry, xs)


def _int8_close(ours_f32, ref_f32, max_ties: int = 2):
    """The barrier's int8 values of two f32 tensors: bitwise but for at
    most ``max_ties`` 1-ulp knife-edges."""
    ours = quantize(ours_f32).values.numpy()
    ref = np.asarray(jquant(jnp.asarray(ref_f32)).values)
    scaled = (ours_f32 / absmax_scale(ours_f32)).numpy()
    assert _near_ties(ours, ref, scaled) <= max_ties


# ---------------------------------------------------------------------------
# chunked_scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [5, 8, 20, 16], ids=["below", "at", "ragged",
                                                    "two-chunks"])
def test_chunked_scan_matches_reference(t):
    """The reference at chunk 8 over T below, at and above it (the port
    at its default chunk 64: its forward is one loop of the steps
    whatever the chunk): a body free of products
    (XLA's CPU backend contracts a product feeding a sum into one fused
    multiply-add, which the port's eager ops do not) gives the carry and
    every y bitwise the reference's — the same steps in the same order;
    a recurrence with products and a tanh within 1e-6."""
    rng = np.random.default_rng(t)
    c0 = rng.standard_normal((2, 3)).astype(np.float32)
    a = rng.uniform(0.5, 1.0, (t, 2, 3)).astype(np.float32)
    b = rng.standard_normal((t, 2, 3)).astype(np.float32)
    xs_j, xs_t = (jnp.asarray(a), jnp.asarray(b)), (_t(a), _t(b))
    jc, jy = jchunked_scan(lambda c, x: (jnp.maximum(c, x[0]) + x[1],
                                         c - x[1]),
                           jnp.asarray(c0), xs_j, chunk=8)
    tc, ty = chunked_scan(stepwise(lambda c, x: (torch.maximum(c, x[0])
                                                 + x[1], c - x[1])),
                          _t(c0), xs_t)
    assert ty.shape == (t, 2, 3)
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    assert np.array_equal(ty.numpy(), np.asarray(jy))
    jc, jy = jchunked_scan(lambda c, x: (c * x[0] + jnp.tanh(x[1]),
                                         c * 2.0 + x[0]),
                           jnp.asarray(c0), xs_j, chunk=8)
    tc, ty = chunked_scan(stepwise(lambda c, x: (c * x[0] + torch.tanh(x[1]),
                                                 c * 2.0 + x[0])),
                          _t(c0), xs_t)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# rwkv6
# ---------------------------------------------------------------------------

def _rwkv_inputs(t: int, seed: int):
    rng = np.random.default_rng(seed)
    d, h, dh = RWKV.d_model, RWKV.n_heads, RWKV.hd
    x = rng.standard_normal((2, t, d)).astype(np.float32)
    x_prev = rng.standard_normal((2, 1, d)).astype(np.float32)
    state = (rng.standard_normal((2, h, dh, dh)) * 0.3).astype(np.float32)
    return x, x_prev, state


@pytest.mark.parametrize("t", [13, 1], ids=["prompt", "decode"])
def test_rwkv_time_mix_matches_reference(served, t):
    """Layer 1's served ``tm`` (ten packed projections): the mixes'
    projections r, k, v, w, g, then the whole time mix — out, the last x
    and the wkv state — from a random state, the reference at chunk 8 (a
    ragged tail at T 13); the int8 barrier values of ``wo``'s input."""
    jqp, tqp = served["rwkv6"]
    jp = jax.tree.map(lambda a: a[1], jqp["layers"]["tm"])
    tp = layer_slice(tqp["layers"], 1)["tm"]
    x, x_prev, state = _rwkv_inputs(t, seed=t)
    want = jax.jit(lambda p_, a, b: jrwkv._time_mix_inputs(JRWKV, p_, a, b))(
        jp, jnp.asarray(x), jnp.asarray(x_prev))
    got = rwkv6._time_mix_inputs(RWKV, tp, _t(x), _t(x_prev))
    for name, g, w in zip("rkvwg", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)
    jout, jlast, jstate = jax.jit(lambda p_, a, b, c: jrwkv.rwkv_time_mix(
        JRWKV, p_, a, b, c, chunk=8))(jp, jnp.asarray(x), jnp.asarray(x_prev),
                                      jnp.asarray(state))
    out, last, st = rwkv6.rwkv_time_mix(RWKV, tp, _t(x), _t(x_prev),
                                        _t(state))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    assert np.array_equal(last.numpy(), np.asarray(jlast))
    np.testing.assert_allclose(st.numpy(), np.asarray(jstate), **TOL)
    # wo's input: the gated group norm of the recurrence's output, on the
    # reference's own projections
    r, k, v, w, g = want
    xs = tuple(a.transpose(1, 0, 2, 3) for a in (r, k, v, w))
    ys = _ys(jrwkv._wkv_step(jp["u"]), jnp.asarray(state), xs)
    y_ref = jrwkv._group_norm(ys.transpose(1, 0, 2, 3), jp["ln_x"],
                              RWKV.n_heads, RWKV.hd).reshape(2, t, -1) * g
    _, tys = rwkv6._wkv(tp["u"], *(_t(a).transpose(0, 1)
                                   for a in (r, k, v, w)), _t(state))
    y = rwkv6._group_norm(tys.transpose(0, 1), tp["ln_x"], RWKV.n_heads,
                          RWKV.hd).reshape(2, t, -1) * _t(g)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)
    _int8_close(y, y_ref)


@pytest.mark.parametrize("t", [13, 1], ids=["prompt", "decode"])
def test_rwkv_channel_mix_matches_reference(served, t):
    """Layer 2's channel mix (three packed projections, relu² and
    sigmoid outside #1): out within 2e-5, the last x bitwise, and the
    int8 barrier values of ``wv_c``'s input (relu² of ``wk_c``)."""
    jqp, tqp = served["rwkv6"]
    jp = jax.tree.map(lambda a: a[2], jqp["layers"]["tm"])
    tp = layer_slice(tqp["layers"], 2)["tm"]
    x, x_prev, _ = _rwkv_inputs(t, seed=10 + t)
    jout, jlast = jax.jit(lambda p_, a, b: jrwkv.rwkv_channel_mix(
        JRWKV, p_, a, b))(jp, jnp.asarray(x), jnp.asarray(x_prev))
    out, last = rwkv6.rwkv_channel_mix(RWKV, tp, _t(x), _t(x_prev))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    assert np.array_equal(last.numpy(), np.asarray(jlast))
    m_k = x + np.asarray(jp["mu_c"][1]) * (
        np.concatenate([x_prev, x[:, :-1]], 1) - x)
    k_ref = jax.jit(lambda n, a: jnp.square(jax.nn.relu(jlinear_apply(
        n, a, quant="ternary"))))(jp["wk_c"], jnp.asarray(m_k))
    k = torch.square(torch.relu(linear_apply(tp["wk_c"], _t(m_k),
                                             quant="ternary")))
    _int8_close(k, k_ref)


@pytest.mark.parametrize("t", [13, rwkv6.WKV_CHUNK,
                               2 * rwkv6.WKV_CHUNK + 22],
                         ids=["below", "at", "ragged"])
def test_wkv_chunks_are_step_for_step(served, t):
    """The port's wkv recurrence forms a chunk's kv products at once and
    its y in one product: state and y bitwise a plain step-at-a-time loop
    of the reference's body (written in torch), over T below, at and
    above the chunk, with a ragged tail."""
    _, tqp = served["rwkv6"]
    u = layer_slice(tqp["layers"], 0)["tm"]["u"]
    rng = np.random.default_rng(t)
    r, k, v = (_t(rng.standard_normal((t, 2, RWKV.n_heads, RWKV.hd))
                  .astype(np.float32)) for _ in range(3))
    w = _t(rng.uniform(0.5, 1.0, (t, 2, RWKV.n_heads, RWKV.hd))
           .astype(np.float32))
    s0 = _t(rng.standard_normal((2, RWKV.n_heads, RWKV.hd, RWKV.hd))
            .astype(np.float32))
    s, ys = s0, []
    for i in range(t):
        kv = k[i][..., :, None] * v[i][..., None, :]
        m = s + u[..., None] * kv
        ys.append(torch.matmul(r[i][..., None, :].double(),
                               m.double())[..., 0, :].float())
        s = w[i][..., :, None] * s + kv
    got_s, got_y = rwkv6._wkv(u, r, k, v, w, s0)
    assert torch.equal(got_s, s) and torch.equal(got_y, torch.stack(ys))


def test_group_norm_and_state_shape():
    """``_group_norm`` (population variance, no bias) within 1e-6 of the
    reference's on rows of large mean; the state shapes and dtypes."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((3, 5, RWKV.n_heads, RWKV.hd)) * 3 + 7).astype(
        np.float32)
    gamma = rng.standard_normal(RWKV.d_model).astype(np.float32)
    want = jrwkv._group_norm(jnp.asarray(x), jnp.asarray(gamma),
                             RWKV.n_heads, RWKV.hd)
    got = rwkv6._group_norm(_t(x), _t(gamma), RWKV.n_heads, RWKV.hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    ref = jrwkv.rwkv_state_shape(JRWKV, 3)
    for name, (shape, dtype) in rwkv6.rwkv_state_shape(RWKV, 3).items():
        assert shape == ref[name].shape and dtype == torch.float32, name


# ---------------------------------------------------------------------------
# mamba
# ---------------------------------------------------------------------------

def _mamba_params(served, sub: str = "sub1", block: int = 1):
    jqp, tqp = served["jamba"]
    jp = jax.tree.map(lambda a: a[block], jqp["blocks"][sub]["mamba"])
    tp = layer_slice(tqp["blocks"], block)[sub]["mamba"]
    return jp, tp


@pytest.mark.parametrize("with_state", [False, True], ids=["prefill",
                                                           "decode"])
def test_causal_conv_bitwise(served, with_state):
    jp, tp = _mamba_params(served)
    rng = np.random.default_rng(5)
    t = 1 if with_state else 9
    x = rng.standard_normal((2, t, JAMBA.d_inner)).astype(np.float32)
    st = (rng.standard_normal((2, JAMBA.mamba_conv - 1, JAMBA.d_inner))
          .astype(np.float32) if with_state else None)
    jy, jst = jmamba._causal_conv(jnp.asarray(x), jp["conv_w"],
                                  jp["conv_b"],
                                  None if st is None else jnp.asarray(st))
    y, new = mamba._causal_conv(_t(x), tp["conv_w"], tp["conv_b"],
                                None if st is None else _t(st))
    assert np.array_equal(y.numpy(), np.asarray(jy))
    assert np.array_equal(new.numpy(), np.asarray(jst))


def test_mamba_forward_and_decode_match_reference(served):
    """Superblock 1's sub1 (a Mamba sublayer over packed in/x/out
    projections and an f32 ``dt_proj``): a 13-token prefill from zero
    states, then a decode step from that state; outputs and the ssm/conv
    states within 2e-5 (the conv state bitwise), and the int8 barrier
    values of ``out_proj``'s input."""
    jp, tp = _mamba_params(served)
    rng = np.random.default_rng(6)
    u = rng.standard_normal((2, 13, JAMBA.d_model)).astype(np.float32)
    u1 = rng.standard_normal((2, 1, JAMBA.d_model)).astype(np.float32)
    jy, jst = jax.jit(lambda p_, a: jmamba.mamba_forward(JJAMBA, p_, a,
                                                         chunk=8))(
        jp, jnp.asarray(u))
    y, st = mamba.mamba_forward(JAMBA, tp, _t(u))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(st["ssm"].numpy(), np.asarray(jst["ssm"]),
                               **TOL)
    assert np.array_equal(st["conv"].numpy(), np.asarray(jst["conv"]))
    # the decode step from the reference's own state
    jy1, jst1 = jax.jit(lambda p_, a, st_: jmamba.mamba_decode_step(
        JJAMBA, p_, a, st_))(jp, jnp.asarray(u1), jst)
    y1, st1 = mamba.mamba_decode_step(
        JAMBA, tp, _t(u1), {k: _t(v) for k, v in jst.items()})
    np.testing.assert_allclose(y1.numpy(), np.asarray(jy1), **TOL)
    for name in ("ssm", "conv"):
        np.testing.assert_allclose(st1[name].numpy(),
                                   np.asarray(jst1[name]), **TOL)
    # out_proj's input on the reference's own stages
    def stages(p_, u_):
        x, z, _, _ = jmamba._ssm_inputs(JJAMBA, p_, u_)
        xc, _ = jmamba._causal_conv(x, p_["conv_w"], p_["conv_b"])
        xc = jax.nn.silu(xc)
        return (xc, z, *jmamba._ssm_project(JJAMBA, p_, xc))
    xc, z, dt, b, c = jax.jit(stages)(jp, jnp.asarray(u))
    xs = tuple(a.transpose(1, 0, 2) for a in (xc, z, dt, b, c))
    h0 = jnp.zeros((2, JAMBA.d_inner, JAMBA.mamba_d_state), jnp.float32)
    ys = _ys(jmamba._scan_step(jp["A_log"], jp["D"]), h0, xs)
    y_ref = ys.transpose(1, 0, 2) * jax.nn.silu(z)
    txs = tuple(_t(a).transpose(0, 1) for a in (xc, dt, b, c))
    _, tys = chunked_scan(stepwise(mamba._scan_step(tp["A_log"], tp["D"])),
                          _t(h0), txs)
    y_in = tys.transpose(0, 1) * rwkv6.silu(_t(z))
    np.testing.assert_allclose(y_in.numpy(), np.asarray(y_ref), **TOL)
    _int8_close(y_in, y_ref)


def test_dt_proj_serves_f32_through_bitlinear_qat(served):
    """Reduced jamba's ``dt_proj`` has k = dt_rank = 8 < 16: it stays an
    f32 ``{"w", "b"}`` node (the reference's ``_eligible``) and serves
    through the QAT BitLinear forward, within 2e-5 of the reference's
    ``linear_apply``; softplus is ``jax.nn.softplus``'s, past 20 too."""
    jp, tp = _mamba_params(served, "sub0", 0)
    assert set(tp["dt_proj"]) == {"w", "b"} and mamba.dt_rank(JAMBA) == 8
    assert "packed" in tp["x_proj"] and "packed" in tp["in_proj"]
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 7, 8)).astype(np.float32)
    b = rng.standard_normal(JAMBA.d_inner).astype(np.float32) * 0.5
    want = jlinear_apply(dict(jp["dt_proj"], b=jnp.asarray(b)),
                         jnp.asarray(x), quant="ternary")
    got = linear_apply(dict(tp["dt_proj"], b=_t(b)), _t(x), quant="ternary")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    v = np.linspace(-40, 40, 801).astype(np.float32)
    np.testing.assert_allclose(mamba.softplus(_t(v)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(v))),
                               rtol=2e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["rwkv6", "jamba"])
def test_serving_tree_matches_reference(masters, served, name):
    """The port's ``quantize_params`` on the reference's master tree:
    the reference's serving tree leaf for leaf — paths, dtypes, shapes;
    codes, biases and f32 leaves bitwise, γ within 1e-6 — and the
    reference's tree through the converter bitwise."""
    jcfg, cfg = PAIRS[name]
    jqp, conv = served[name]
    want = _flat(jax.tree.map(np.asarray, jqp))
    got = _flat(quantize_params(cfg, from_numpy_tree(
        jax.tree.map(np.asarray, masters[name]), "cpu")))
    assert set(got) == set(want)
    for path, leaf in want.items():
        assert got[path].numpy().dtype == leaf.dtype, path
        assert got[path].shape == leaf.shape, path
        if "scale" in jax.tree_util.keystr(path):
            np.testing.assert_allclose(got[path].numpy(), leaf, rtol=1e-6,
                                       atol=0, err_msg=str(path))
        else:
            assert np.array_equal(got[path].numpy(), leaf), path
    for path, leaf in _flat(conv).items():
        assert np.array_equal(leaf.numpy(), want[path]), path
    keys = {jax.tree_util.keystr(p) for p in want}
    if name == "rwkv6":
        assert "['layers']['tm']['w_lora_b']['packed']" in keys
        assert "['layers']['tm']['u']" in keys
    else:
        for part in ("['blocks']['sub2']['attn']['wqkv']['packed']",
                     "['blocks']['sub1']['moe']['gu_packed']",
                     "['blocks']['sub0']['ffn']['gu_packed']",
                     "['blocks']['sub0']['mamba']['dt_proj']['w']",
                     "['blocks']['sub3']['mamba']['A_log']"):
            assert part in keys, part


@pytest.mark.parametrize("name", ["rwkv6", "jamba"])
def test_master_tree_matches_reference(masters, name):
    _, cfg = PAIRS[name]
    ours = _flat(init_params(cfg, 3, "cpu"))
    ref = _flat(masters[name])
    assert set(ours) == set(ref)
    for path, leaf in ref.items():
        assert tuple(ours[path].shape) == leaf.shape, path


def test_full_width_dt_proj_packs_with_its_bias():
    """Where dt_rank reaches 16 (full-width jamba's is 512; here d 1024
    gives 64, a size the CPU draws quickly) ``dt_proj`` packs and keeps
    its bias: the serving node is #1 with the bias epilogue."""
    from repro_torch.models.mamba import mamba_init
    from repro_torch.serving.quantize import quantize_layer
    cfg = get_config("jamba-1.5-large-398b").replace(d_model=1024,
                                                     n_heads=8, n_kv_heads=2)
    gen = torch.Generator().manual_seed(0)
    node = quantize_layer({"mamba": mamba_init(gen, cfg, device="cpu")})
    dt = node["mamba"]["dt_proj"]
    assert set(dt) == {"packed", "scale", "b"}
    assert dt["packed"].shape == (mamba.dt_rank(cfg) // 4, cfg.d_inner)
