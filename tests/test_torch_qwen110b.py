"""qwen1.5-110b in the port, held against the JAX reference on the CPU:
``qwen1.5-110b-reduced`` (3 layers, d 128, 4 heads of 32 over 2: G 2) and
a G 8 variant of it (``.replace(n_heads=8, n_kv_heads=1)`` on both
packages' configs: the full model's 64 heads over 8), each served from
one master tree (the port's seeded draw, its QKV biases drawn nonzero
with numpy) quantized by the reference and converted to the port:

  * the full config's G 8, head_dim 128 and QKV bias, and the decode
    kernels' shared memory at its served shape (capacity 1664) under every
    ring depth the tile sweep may pick;
  * greedy tokens at G 8: the port's Scheduler (chunked prefill) equals
    the reference's ``lockstep_generate`` and the port's, LOP and no-LOP;
  * one whole prefill's logits at G 2 and G 8 within rtol = atol = 2e-5;
  * the decode attention's plain version at G 8 and dh 128 against the
    reference's interpret-mode Pallas kernel at M 128, LOP and dense.

One served tree a config, shared across cases. The reference's share is
mostly its compiles, ~5–9 s a (config, mode) of ``lockstep_generate``
against ~3 s a prefill, so G 2 is held at the prefill."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.qwen1_5_110b import CONFIG as JFULL
from repro.configs.qwen1_5_110b import REDUCED as JQWEN
from repro.core.lop import lop_features, pack_features
from repro.kernels import ops as jops
from repro.serving import engine as jeng
from repro.serving.quantize import quantize_params as jquantize
from repro.serving.scheduler import lockstep_generate as jlockstep
from repro_torch.configs import get_config
from repro_torch.convert import from_numpy_tree
from repro_torch.kernels import autotune
from repro_torch.kernels import ops as tops
from repro_torch.models.transformer import init_params
from repro_torch.serving import engine as teng
from repro_torch.serving.api import GenerateRequest, PooledEngine
from repro_torch.serving.lop_select import k_keep_blocks
from repro_torch.serving.scheduler import Scheduler, lockstep_generate

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)
MAX_LEN = 63                       # pool capacity 64 (lop_block 32)
GEN = 6
G8 = dict(n_heads=8, n_kv_heads=1)
CFGS = {"g2": (JQWEN, get_config("qwen1.5-110b-reduced")),
        "g8": (JQWEN.replace(**G8),
               get_config("qwen1.5-110b-reduced").replace(**G8))}


def _masters(cfg, seed: int = 0):
    """The port's seeded master tree as the reference's arrays, with
    ``wq/wk/wv.b`` drawn as 0.02·N(0, 1) (numpy, seeded) in place of the
    zeros."""
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                          init_params(cfg, seed, "cpu"))
    rng = np.random.default_rng(seed)
    attn = params["layers"]["attn"]
    for name in ("wq", "wk", "wv"):
        b = attn[name]["b"]
        attn[name]["b"] = jnp.asarray(
            rng.standard_normal(b.shape).astype(np.float32) * 0.02)
    return params


@pytest.fixture(scope="module")
def weights():
    """name → (reference serving tree, the same converted to the port)."""
    out = {}
    for name, (jcfg, cfg) in CFGS.items():
        jqp = jax.jit(jquantize, static_argnums=0)(jcfg, _masters(cfg))
        out[name] = (jqp, from_numpy_tree(jax.tree.map(np.asarray, jqp),
                                          "cpu"))
    return out


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(110)
    return [rng.integers(0, JQWEN.vocab, (40,)).astype(np.int32)
            for _ in range(2)]


def test_config_and_decode_plan_at_group_8():
    full = get_config("qwen1.5-110b")
    assert (full.n_heads // full.n_kv_heads, full.hd) == (8, 128)
    assert full.qkv_bias and full.d_ff == 49152 and full.n_layers == 80
    assert (JFULL.n_heads, JFULL.n_kv_heads, JFULL.head_dim) == (
        full.n_heads, full.n_kv_heads, full.hd)
    for name, (jcfg, cfg) in CFGS.items():
        assert cfg.n_heads // cfg.n_kv_heads == {"g2": 2, "g8": 8}[name]
        assert (jcfg.n_heads, jcfg.n_kv_heads) == (cfg.n_heads,
                                                   cfg.n_kv_heads)
    m = 1664                       # 4 slots at 1536 + 32 tokens
    dims = dict(bhg=4 * full.n_heads, g=8, d=full.hd, m=m,
                block=full.lop_block, k_keep=k_keep_blocks(full, m))
    for stages in autotune.DECODE_STAGES:
        for lop in (True, False):
            assert autotune.decode_smem(dims, stages, lop) \
                <= autotune.smem_budget()
        assert autotune.valid_params("decode", dims, {"stages": stages})


@pytest.mark.parametrize("use_lop", [True, False], ids=["lop", "no-lop"])
@pytest.mark.parametrize("name", ["g8"])
def test_scheduler_matches_reference_lockstep(weights, prompts, name,
                                              use_lop):
    """2 requests of 40 tokens (two chunks each) on 2 slots, chunked
    prefill, greedy: each stream equals the reference's lockstep on the
    same weights and the port's own."""
    jqp, tqp = weights[name]
    jcfg, cfg = CFGS[name]
    eng = PooledEngine(cfg, tqp, max_len=MAX_LEN, use_lop=use_lop,
                       device="cpu")
    sched = Scheduler(eng, n_slots=2, check_invariants=True)
    assert sched.chunked
    for rid, p in enumerate(prompts):
        sched.submit(GenerateRequest(rid=rid, prompt=p, max_new_tokens=GEN))
    got = {r.rid: r.tokens for r in sched.run_to_completion()}
    for rid, p in enumerate(prompts):
        want = jlockstep(jcfg, jqp, p, GEN, max_len=MAX_LEN,
                         use_lop=use_lop)
        assert got[rid] == want, (rid, got[rid], want)
        assert got[rid] == lockstep_generate(eng, p, GEN), rid


@pytest.mark.parametrize("name", sorted(CFGS))
def test_prefill_logits_match_reference(weights, prompts, name):
    jqp, tqp = weights[name]
    jcfg, cfg = CFGS[name]
    p = prompts[0]
    want, _ = jeng.prefill(jcfg, jqp, p[None], max_len=MAX_LEN)
    got, _ = teng.prefill(cfg, tqp, torch.from_numpy(p[None]),
                          max_len=MAX_LEN)
    want = torch.from_numpy(np.array(want))
    assert got.shape == want.shape == (1, cfg.vocab_padded)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("use_lop", [True, False], ids=["lop", "dense"])
def test_decode_plain_at_group_8_matches_pallas(use_lop):
    """B 2, 16 heads of 128 over 2 (G 8), M 128 in blocks of 32, a lane
    retired: the plain version against the interpret-mode kernel."""
    rng = np.random.default_rng(8 + use_lop)
    b, h, hkv, m, dh = 2, 16, 2, 128, 128
    qi = rng.integers(-60, 61, (b, h, dh)).astype(np.int8)
    qs = rng.uniform(0.005, 0.02, (b, h, 1)).astype(np.float32)
    k = rng.integers(-60, 61, (b, hkv, m, dh)).astype(np.int8)
    v = rng.integers(-60, 61, (b, hkv, m, dh)).astype(np.int8)
    ks = rng.uniform(0.005, 0.02, (b, hkv, m)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, (b, hkv, m)).astype(np.float32)
    feat = np.asarray(pack_features(lop_features(jnp.asarray(k))))
    arrs = (qi, qs, k, v, ks, vs, feat)
    new_len = np.asarray([100, 0], np.int32)
    kw = dict(block=32, k_keep=2, use_lop=use_lop)
    want = jops.decode_attention(*map(jnp.asarray, arrs),
                                 jnp.asarray(new_len), impl="pallas", **kw)
    got = tops.decode_attention(*(torch.from_numpy(a) for a in arrs),
                                torch.from_numpy(new_len), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not got[1].any()
