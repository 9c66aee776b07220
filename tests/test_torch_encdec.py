"""The port's encoder–decoder family on ``whisper-small-reduced`` (2
encoder and 2 decoder layers, d 96, 4 heads of 24, ungated gelu FFN,
LayerNorm, cross capacity 64), held against the JAX reference on the CPU:

  * the port's ``quantize_params`` on the reference's master tree (with
    nonzero biases on every ``wq/wk/wv`` of ``attn`` and ``xattn``) gives
    the reference's serving tree leaf for leaf — ``xattn.wkv`` (K ‖ V),
    ``xattn.wq`` with its bias, the ungated ``gu_*`` of ``up`` alone,
    ``enc_layers`` and ``ln_enc`` — and the tree converts bitwise;
  * the port's seeded master tree has the reference's paths and shapes;
  * each encoder layer stage by stage on the reference's input to each
    stage: LayerNorm within 1e-6, int8 q/k/v bitwise but for 1-ulp
    knife-edges, #3 non-causal over the unpadded frames, the O projection
    and the ungated gelu FFN within rtol = atol = 2e-5;
  * ``build_cross_cache``: int8 K/V, scales and packed LOP features
    bitwise the reference's; the prefill logits within 2e-5;
  * the reference's ``test_encdec_requests_carry_frames`` scenario: the
    port's Scheduler (exact-length prefill) equals the reference's
    ``lockstep_generate`` with the same frames, LOP and no-LOP, and a
    request with more frames than the pool's cross capacity is rejected at
    ``submit``;
  * the pool's cross pages: insert, extract and evict (features zeroed,
    ``cross_len`` kept), and a transient NaN lane recovered through the
    retry with its stream bitwise the clean one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.whisper_small import REDUCED as JCFG
from repro.core.qlinear import qlinear as jqlinear
from repro.kernels import ops as jops
from repro.models.layers import norm_apply as jnorm_apply
from repro.models.moe import ffn_apply as jffn_apply
from repro.models.transformer import init_params as jinit
from repro.serving import engine as jeng
from repro.serving.quantize import quantize_params as jquantize
from repro.serving.scheduler import lockstep_generate as jlockstep
from repro_torch.configs import get_config
from repro_torch.convert import from_numpy_tree
from repro_torch.models.transformer import init_params, layer_slice
from repro_torch.serving import engine as teng
from repro_torch.serving import faults
from repro_torch.serving.api import GenerateRequest, PooledEngine
from repro_torch.serving.cache import cross_capacity_for, init_cache
from repro_torch.serving.quantize import quantize_params
from repro_torch.serving.scheduler import Scheduler, lockstep_generate

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)
MAX_LEN = 40          # the reference's scenario: capacity 64
CFG = get_config("whisper-small-reduced")


def _flat(tree) -> dict:
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


@pytest.fixture(scope="module")
def master():
    params, _ = jinit(JCFG, jax.random.PRNGKey(0))
    return params


@pytest.fixture(scope="module")
def weights(master):
    jqp = jquantize(JCFG, master)
    return jqp, from_numpy_tree(jax.tree.map(np.asarray, jqp), "cpu")


def _frames(rng, n: int):
    return (rng.standard_normal((n, CFG.d_model)).astype(np.float32)
            * 0.02)


def _with_biases(params, seed: int = 3):
    """Nonzero 0.02·N(0, 1) ``b`` on every ``wq/wk/wv`` of the decoder's
    ``attn`` and ``xattn`` and the encoder's ``attn``."""
    rng = np.random.default_rng(seed)
    out = jax.tree.map(np.asarray, params)
    for stack, blocks in (("layers", ("attn", "xattn")),
                          ("enc_layers", ("attn",))):
        for blk in blocks:
            for name in ("wq", "wk", "wv"):
                w = out[stack][blk][name]["w"]
                shape = w.shape[:-2] + w.shape[-1:]
                out[stack][blk][name]["b"] = (rng.standard_normal(shape)
                                              .astype(np.float32) * 0.02)
    return out


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def test_quantize_encdec_tree_matches_reference(master):
    """Codes, biases, norms, embed and head bitwise, γ at rtol 1e-6; the
    reference's serving tree with biases also round-trips the converter
    bitwise."""
    biased = _with_biases(master)
    want_tree = jax.tree.map(np.asarray, jquantize(
        JCFG, jax.tree.map(jnp.asarray, biased)))
    want = _flat(want_tree)
    got = _flat(quantize_params(CFG, from_numpy_tree(biased, "cpu")))
    assert set(got) == set(want)
    keys = {jax.tree_util.keystr(p) for p in want}
    for part in ("['xattn']['wkv']['b']", "['xattn']['wq']['b']",
                 "['attn']['wqkv']['b']", "['ln_enc']['b']",
                 "['ffn']['gu_packed']"):
        assert any(k.endswith(part) for k in keys), part
    for path, leaf in want.items():
        if "scale" in jax.tree_util.keystr(path):
            np.testing.assert_allclose(got[path].numpy(), leaf, rtol=1e-6,
                                       atol=0, err_msg=str(path))
        else:
            assert np.array_equal(got[path].numpy(), leaf), path
    # ungated: gate ‖ up is up alone
    gu = got[next(p for p in got if jax.tree_util.keystr(p).endswith(
        "['layers']['ffn']['gu_packed']"))]
    assert gu.shape[-1] == CFG.d_ff
    conv = _flat(from_numpy_tree(want_tree, "cpu"))
    for path, leaf in want.items():
        assert conv[path].numpy().dtype == leaf.dtype, path
        assert np.array_equal(conv[path].numpy(), leaf), path


def test_master_tree_matches_reference(master):
    ours = _flat(init_params(CFG, 7, "cpu"))
    ref = _flat(master)
    assert set(ours) == set(ref)
    for path, leaf in ref.items():
        assert ours[path].shape == leaf.shape, path
    assert "w_gate" not in init_params(CFG, 7, "cpu")["layers"]["ffn"]


# ---------------------------------------------------------------------------
# encoder, cross cache, prefill
# ---------------------------------------------------------------------------

def _ref_encoder_layers(jqp, frames):
    """The reference prefill's encoder stack (``src/repro/serving/
    engine.py``, ``enc_body``), run eagerly layer by layer. → per layer its
    stages: input ``x``, LayerNorm ``h``, the #3 operands (int8 q/k/v and
    scales), attention ``o`` [B, S, q_dim], the residual after the O
    projection ``r``, ``ln2``'s output ``h2`` and the FFN's ``y``."""
    e = jnp.asarray(frames)
    layers = []
    for i in range(JCFG.n_encoder_layers):
        lp = jax.tree.map(lambda a: a[i], jqp["enc_layers"])
        h = jnorm_apply(lp["ln1"], e, JCFG.norm)
        q, k, v = jeng._project_qkv(JCFG, lp["attn"], h)
        qi, qsc = jeng._q(q)
        ki, vi, ksc, vsc, _ = jeng._quantize_kv(k, v)
        ops_in = (qi.transpose(0, 2, 1, 3), qsc[..., 0].transpose(0, 2, 1),
                  ki, vi, ksc, vsc,
                  jnp.full((e.shape[0],), e.shape[1], jnp.int32))
        o = jops.prefill_attention(*ops_in, causal=False)
        o = o.transpose(0, 2, 1, 3).reshape(e.shape[0], e.shape[1],
                                            JCFG.q_dim)
        r = e + jqlinear(lp["attn"]["wo"], o)
        h2 = jnorm_apply(lp["ln2"], r, JCFG.norm)
        y = jffn_apply(JCFG, lp["ffn"], h2)
        layers.append(dict(x=e, h=h, ops_in=ops_in, o=o, r=r, h2=h2, y=y))
        e = r + y
    return layers


def _near_ties(ours, ref, f32):
    """Where the int8 tensors ``ours`` and ``ref`` differ, the port's
    scaled f32 value ``f32`` must lie within 1e-5 of a rounding boundary
    (a 1-ulp knife-edge). → the number of such entries."""
    apart = np.nonzero(ours != ref)
    frac = np.abs(np.abs(f32[apart]) % 1.0 - 0.5)
    assert (frac <= 1e-5).all(), f32[apart]
    return len(apart[0])


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("s_enc", [36])
def test_encoder_layers_match_reference(weights, s_enc):
    """Each encoder layer, stage by stage, each stage on the reference's
    own input to it: LayerNorm within 1e-6; int8 q/k/v bitwise but for
    1-ulp knife-edges (scaled values within 1e-5 of a rounding boundary,
    at most 2 a tensor); #3 non-causal over the unpadded frames, the O
    projection and the ungated gelu FFN within rtol = atol = 2e-5. (The
    encoder's output as a whole is not held within 2e-5: one knife-edge
    moves every row of the next layer, since each row attends every
    frame; the serving tests hold the tokens.)"""
    from repro_torch.core.quantization import absmax_scale
    from repro_torch.kernels import ops as tops
    from repro_torch.models.layers import ffn_apply
    jqp, tqp = weights
    frames = _frames(np.random.default_rng(s_enc), s_enc)[None]
    for i, ref in enumerate(_ref_encoder_layers(jqp, frames)):
        lp = layer_slice(tqp["enc_layers"], i)
        for norm, x, h in (("ln1", "x", "h"), ("ln2", "r", "h2")):
            got = teng.norm_apply(lp[norm], _t(ref[x]), CFG.norm)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref[h]),
                                       rtol=1e-6, atol=1e-6)
        qkv = teng._project_qkv(CFG, lp["attn"], _t(ref["h"]))
        ints = (ref["ops_in"][0].transpose(0, 2, 1, 3), ref["ops_in"][2],
                ref["ops_in"][3])
        for t, want in zip(qkv, ints):
            want = np.asarray(want)
            scaled = (t / absmax_scale(t)).numpy()
            ours = teng._q(t)[0].numpy()
            if want.shape != ours.shape:            # k, v: [B, Hkv, S, dh]
                scaled, ours = (a.transpose(0, 2, 1, 3) for a in (scaled,
                                                                  ours))
            assert _near_ties(ours, want, scaled) <= 2
        o = tops.prefill_attention(*map(_t, ref["ops_in"]), causal=False)
        np.testing.assert_allclose(
            o.transpose(1, 2).reshape(ref["o"].shape).numpy(),
            np.asarray(ref["o"]), **TOL)
        r = _t(ref["x"]) + teng.qlinear(lp["attn"]["wo"], _t(ref["o"]))
        np.testing.assert_allclose(r.numpy(), np.asarray(ref["r"]), **TOL)
        y = ffn_apply(CFG, lp["ffn"], _t(ref["h2"]))
        np.testing.assert_allclose(y.numpy(), np.asarray(ref["y"]), **TOL)


def test_cross_cache_matches_reference(weights):
    """On one encoder memory, each decoder layer's cross cache is bitwise
    the reference's ``build_cross_cache`` (rows above S_enc zero on both
    sides)."""
    jqp, tqp = weights
    enc = _frames(np.random.default_rng(5), 37)[None] * 50.0
    cap = cross_capacity_for(CFG)
    cache = init_cache(CFG, 1, MAX_LEN, "cpu")
    for i in range(CFG.n_layers):
        ref = jeng.build_cross_cache(
            JCFG, jax.tree.map(lambda a: a[i], jqp["layers"]["xattn"]),
            jnp.asarray(enc), cap)
        ours = teng.build_cross_cache(
            CFG, layer_slice(tqp["layers"], i)["xattn"],
            torch.from_numpy(enc), layer_slice(cache["cross"], i))
        for key, leaf in ref.items():
            assert ours[key].dtype == _t(leaf).dtype, key
            assert np.array_equal(ours[key].numpy(), np.asarray(leaf)), \
                (i, key)


def test_prefill_logits_match_reference(weights):
    """The scenario's requests, through the reference engine's compiled
    prefill (the one its lockstep uses): the first request's logits within
    2e-5 (the second's encoder has a knife-edge, see above), the caches'
    shapes and ``cross_len`` the reference's, the decoder's self-attention
    K bitwise; an encdec prefill without frames raises, and one with more
    frames than ``cross_ctx`` grows its cross pages."""
    from repro.serving.scheduler import _ref_engine
    jqp, tqp = weights
    req = _requests()[0]
    want, jc = _ref_engine(JCFG, jqp, True, MAX_LEN).prefill(
        req.prompt[None], len(req.prompt),
        {"frames": jnp.asarray(req.frames)[None]})
    got, cache = teng.prefill(CFG, tqp, _t(req.prompt).long()[None],
                              frames=_t(req.frames)[None], max_len=MAX_LEN)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert int(cache["cross_len"][0]) == int(jc["cross_len"][0]) == 24
    for tree in ("layers", "cross"):
        for key, leaf in jc[tree].items():
            assert cache[tree][key].shape == leaf.shape, (tree, key)
    assert np.array_equal(cache["layers"]["k"].numpy(),
                          np.asarray(jc["layers"]["k"]))
    with pytest.raises(ValueError):
        teng.prefill(CFG, tqp, _t(req.prompt).long()[None])
    # more frames than cross_ctx: the cross pages grow to their block
    # roundup, as the reference's enc_cap does (a pool refuses such a
    # request at submit)
    big = _frames(np.random.default_rng(7), CFG.cross_ctx + 6)[None]
    logits, cache = teng.prefill(CFG, tqp, _t(req.prompt).long()[None],
                                 frames=_t(big), max_len=MAX_LEN)
    assert cache["cross"]["k"].shape[3] == 96
    assert int(cache["cross_len"][0]) == 70
    assert torch.isfinite(logits).all()


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _requests():
    """The reference's ``test_encdec_requests_carry_frames`` requests."""
    rng = np.random.default_rng(9)
    reqs = []
    for rid, plen in enumerate([6, 9]):
        p = rng.integers(0, CFG.vocab, (plen,)).astype(np.int32)
        reqs.append(GenerateRequest(rid=rid, prompt=p, max_new_tokens=4,
                                    frames=_frames(rng, 4 * plen)))
    return reqs


@pytest.mark.parametrize("use_lop", [True, False], ids=["lop", "no-lop"])
def test_requests_carry_frames_match_reference(weights, use_lop):
    jqp, tqp = weights
    eng = PooledEngine(CFG, tqp, max_len=MAX_LEN, use_lop=use_lop,
                       device="cpu")
    assert eng.exact_length_prefill and not eng.supports_chunked
    assert eng.prefix_block == 0 and not eng.supports_speculative
    sched = Scheduler(eng, n_slots=2, check_invariants=True,
                      spec_decode=True)
    assert not sched.chunked and not sched.spec
    assert sched.prefix_store is None and sched.cross_capacity == 64
    reqs = _requests()
    for r in reqs:
        sched.submit(r)
    got = {r.rid: r.tokens for r in sched.run_to_completion()}
    for r in reqs:
        want = jlockstep(JCFG, jqp, r.prompt, 4, max_len=MAX_LEN,
                         use_lop=use_lop, frames=r.frames)
        assert got[r.rid] == want, r.rid
        assert got[r.rid] == lockstep_generate(eng, r.prompt, 4,
                                               frames=r.frames), r.rid
    # oversized encoder input is rejected up front, not at insert time
    with pytest.raises(ValueError, match="cross capacity"):
        sched.submit(GenerateRequest(
            rid=9, prompt=reqs[0].prompt, max_new_tokens=2,
            frames=np.zeros((CFG.cross_ctx + 33, CFG.d_model), np.float32)))
    with pytest.raises(ValueError, match="frames"):
        sched.submit(GenerateRequest(rid=10, prompt=reqs[0].prompt,
                                     max_new_tokens=2))
    assert not sched.queue


def test_pool_cross_pages(weights):
    """insert copies a request's cross pages and ``cross_len`` into its
    lane; extract copies them back out; evict zeroes the lane's feature
    rows, cross ones too, and keeps ``cross_len``."""
    _, tqp = weights
    eng = PooledEngine(CFG, tqp, max_len=MAX_LEN, device="cpu")
    pool = eng.init_pool(2)
    req = _requests()[1]
    _, cache = eng.prefill(req.prompt[None], frames=req.frames)
    eng.insert(pool, 1, cache)
    lane = eng.extract(pool, 1)
    assert int(lane["cross_len"][0]) == len(req.frames) == 36
    for tree in ("layers", "cross"):
        for key, leaf in cache[tree].items():
            assert torch.equal(lane[tree][key], leaf), (tree, key)
    assert not pool["cross"]["k"][:, 0].any()
    eng.evict(pool, 1)
    assert not pool["cross"]["feat"][:, 1].any()
    assert not pool["layers"]["feat"][:, 1].any()
    assert int(pool["cross_len"][1]) == 36 and not bool(pool["active"][1])
    assert torch.equal(pool["cross"]["k"][:, 1], cache["cross"]["k"][:, 0])


def test_transient_nan_recovers_through_the_retry(weights):
    _, tqp = weights
    eng = PooledEngine(CFG, tqp, max_len=MAX_LEN, device="cpu")
    streams = []
    for plan in (faults.FaultPlan(),
                 faults.FaultPlan(nan_logits=frozenset({(1, 0), (2, 1)}))):
        sched = Scheduler(eng, n_slots=2, check_invariants=True)
        with faults.inject(plan):
            for r in _requests():
                sched.submit(dataclasses.replace(r, arrival=None))
            streams.append({r.rid: r.tokens
                            for r in sched.run_to_completion()})
    assert sched.fault_events >= 1
    assert sched.fault_recoveries == sched.fault_events
    assert streams[0] == streams[1]


def test_sequence_parallel_cross_decode(weights):
    """``serve_step(sp_axes=("model",))`` on a single-process mesh of two
    token shards (dense attention, so both sides attend every key): the
    cross pages are read through ``sp_decode_attention(write=False)``,
    nothing is written to them, and the logits are within 2e-5 of the
    local step's."""
    from repro_torch.distributed.partitioning import use_mesh
    from repro_torch.launch.mesh import local_mesh
    _, tqp = weights
    eng = PooledEngine(CFG, tqp, max_len=MAX_LEN, use_lop=False,
                       device="cpu")
    req = _requests()[1]
    logits, cache = eng.prefill(req.prompt[None], frames=req.frames)
    tok = torch.argmax(logits, -1)[:, None]
    copy = {k: ({kk: vv.clone() for kk, vv in v.items()}
                if isinstance(v, dict) else v.clone())
            for k, v in cache.items()}
    want, _ = teng.serve_step(CFG, tqp, cache, tok, use_lop=False)
    with use_mesh(local_mesh((2,))):
        sharded = teng.shard_cache(copy)
        got, _ = teng.serve_step(CFG, tqp, sharded, tok, use_lop=False,
                                 sp_axes=("model",))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    for key, leaf in cache["cross"].items():
        assert torch.equal(copy["cross"][key], leaf), key
