"""The port's recurrent families served, held against the JAX reference
on the CPU: ``rwkv6-1.6b-reduced`` (ssm) and
``jamba-1.5-large-398b-reduced`` (hybrid: per superblock Mamba, Mamba +
MoE, attention, Mamba + MoE), with the reference's served weights carried
over by :mod:`repro_torch.convert`:

  * ``init_cache`` / ``init_cache_pool``: the reference's leaves, shapes
    and dtypes (the hybrid pages stacked over superblocks, Mamba states
    with their slot axis at 2), ``pool_capacity`` 0 for the attention-free
    pool, and the engine's capabilities (exact-length prefill, no prefix
    store, no speculation, the reference's state kinds);
  * ``insert_slot`` / ``extract_slot`` / ``evict_slot`` on random pools,
    every leaf bitwise the reference's ops;
  * prefill logits within 2e-5 of the reference's compiled prefill, the
    states too; prefill(S) + ``serve_step`` against prefill(S + 1) (the
    reference's ``test_prefill_plus_decode_equals_full_prefill``);
  * the reference's ``test_recurrent_family_uses_exact_length_prefill``
    scenario for both: the port's Scheduler tokens equal the reference's
    ``lockstep_generate``, greedy and sampled, and jamba LOP and no-LOP;
  * one transient NaN lane on a 2-lane rwkv6 pool: the port's streams
    equal the reference's under the same ``FaultPlan``. The reference's
    retry steps every lane's recurrent state once more (a recurrent state
    ignores ``active`` and cannot be rolled back), so the faulted and the
    other lane part from their clean streams; the port copies that.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.jamba_1_5_large_398b import REDUCED as JJAMBA
from repro.configs.rwkv6_1_6b import REDUCED as JRWKV
from repro.models.transformer import init_params as jinit
from repro.serving import cache as jcache
from repro.serving import faults as jfaults
from repro.serving.api import GenerateRequest as JRequest
from repro.serving.api import SamplingParams as JSampling
from repro.serving.quantize import quantize_params as jquantize
from repro.serving.scheduler import Scheduler as JScheduler
from repro.serving.scheduler import _ref_engine
from repro.serving.scheduler import lockstep_generate as jlockstep
from repro_torch.configs import get_config
from repro_torch.convert import from_numpy_tree
from repro_torch.serving import cache, faults
from repro_torch.serving import engine as teng
from repro_torch.serving.api import (GenerateRequest, PooledEngine,
                                     SamplingParams)
from repro_torch.serving.scheduler import Scheduler, lockstep_generate

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)
MAX_LEN = 63          # the reference's scenario: capacity 64 (jamba)
RWKV = get_config("rwkv6-1.6b-reduced")
JAMBA = get_config("jamba-1.5-large-398b-reduced")
PAIRS = {"rwkv6": (JRWKV, RWKV), "jamba": (JJAMBA, JAMBA)}
SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.9)


def _flat(tree) -> dict:
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def weights():
    """name → (the reference's serving tree, the same converted); drawn
    and quantized under ``jax.jit``."""
    out = {}
    for name, (jcfg, _) in PAIRS.items():
        master = jax.jit(lambda k, c=jcfg: jinit(c, k)[0])(
            jax.random.PRNGKey(0))
        jqp = jax.jit(lambda p, c=jcfg: jquantize(c, p))(master)
        out[name] = (jqp, from_numpy_tree(_np(jqp), "cpu"))
    return out


@pytest.fixture(scope="module")
def engines(weights):
    """(name, use_lop) → the port's engine on the reference's weights."""
    return {(name, lop): PooledEngine(PAIRS[name][1], weights[name][1],
                                      max_len=MAX_LEN, use_lop=lop,
                                      device="cpu")
            for name, lop in (("rwkv6", True), ("jamba", True),
                              ("jamba", False))}


def _prompts(cfg, lens, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, (n,)).astype(np.int32) for n in lens]


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["rwkv6", "jamba"])
def test_cache_and_pool_match_reference(engines, name):
    """``init_cache(cfg, 2, 100)`` and ``init_cache_pool(cfg, 2, 60)``:
    the reference's leaves, shapes and dtypes (its ``test_init_cache_
    shapes`` and ``test_pool_tree_matches_lockstep_cache_plus_active``);
    ``pool_capacity`` the reference's (0 for rwkv6); the engine declares
    the reference's capabilities."""
    jcfg, cfg = PAIRS[name]
    for ours, ref in ((cache.init_cache(cfg, 2, 100, "cpu"),
                       jcache.init_cache(jcfg, 2, 100)),
                      (cache.init_cache_pool(cfg, 2, 60, "cpu"),
                       jcache.init_cache_pool(jcfg, 2, 60))):
        want, got = _flat(_np(ref)), _flat(ours)
        assert set(got) == set(want)
        for path, leaf in want.items():
            assert got[path].numpy().dtype == leaf.dtype, path
            assert got[path].shape == leaf.shape, path
            assert not got[path].any(), path
        assert cache.pool_capacity(ours) == jcache.pool_capacity(ref)
    assert (cache.pool_capacity(cache.init_cache_pool(cfg, 2, 60, "cpu"))
            == (0 if name == "rwkv6" else 64))
    eng = engines[(name, True)]
    assert eng.exact_length_prefill and not eng.supports_chunked
    assert eng.prefix_block == 0 and not eng.supports_speculative
    assert eng.state_kind == {"rwkv6": "recurrent", "jamba": "hybrid"}[name]


def _random_tree(tree, rng):
    """Random values in the dtypes and shapes of a zero cache tree."""
    def fill(a):
        a = np.asarray(a)
        if a.dtype == np.bool_:
            return rng.random(a.shape) < 0.5
        if np.issubdtype(a.dtype, np.integer):
            info = np.iinfo(a.dtype)
            return rng.integers(max(info.min, -100), min(info.max, 100),
                                a.shape).astype(a.dtype)
        return rng.standard_normal(a.shape).astype(a.dtype)
    return jax.tree.map(fill, tree)


@pytest.mark.parametrize("name", ["rwkv6", "jamba"])
def test_slot_ops_bitwise_reference(name):
    """insert a random batch-1 cache into lane 1 of a random 3-lane pool,
    extract lane 1, evict lane 0: every leaf of each result bitwise the
    reference's ops (the Mamba states at slot axis 2, the pages at 1;
    the port's extract views leave the key schedule to the engine's
    ``extract``)."""
    jcfg, cfg = PAIRS[name]
    rng = np.random.default_rng(11)
    pool = _random_tree(_np(jcache.init_cache_pool(jcfg, 3, 40)), rng)
    req = _random_tree(_np(jcache.init_cache(jcfg, 1, 40)), rng)
    want = _np(jcache.insert_slot(jax.tree.map(jnp.asarray, pool), 1,
                                  jax.tree.map(jnp.asarray, req)))
    got = cache.insert_slot(from_numpy_tree(pool, "cpu"), 1,
                            from_numpy_tree(req, "cpu"))
    for path, leaf in _flat(want).items():
        assert np.array_equal(_flat(got)[path].numpy(), leaf), path
    lane = _flat(_np(jcache.extract_slot(jax.tree.map(jnp.asarray, want),
                                         1)))
    ours = _flat(cache.extract_slot(got, 1))
    # the key schedule rides in the engine's extract, not the views
    assert {jax.tree_util.keystr(p) for p in set(lane) - set(ours)} == {
        "['seed']", "['sample_step']"}
    for path in set(lane) - set(ours):
        del lane[path]
    for path, leaf in lane.items():
        assert np.array_equal(ours[path].numpy(), leaf), path
    want = _np(jcache.evict_slot(jax.tree.map(jnp.asarray, want), 0))
    got = cache.evict_slot(got, 0)
    for path, leaf in _flat(want).items():
        assert np.array_equal(_flat(got)[path].numpy(), leaf), path


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["rwkv6", "jamba"])
def test_prefill_matches_reference(weights, name):
    """A 19-token prompt through the reference engine's compiled prefill
    (the one its lockstep runs): logits within 2e-5, the recurrent states
    within 2e-5, lengths equal."""
    jcfg, cfg = PAIRS[name]
    jqp, tqp = weights[name]
    prompt = _prompts(cfg, [19], seed=3)[0]
    want, jc = _ref_engine(jcfg, jqp, True, MAX_LEN).prefill(
        prompt[None], len(prompt), {})
    got, tc = teng.prefill(cfg, tqp, torch.from_numpy(prompt).long()[None],
                           max_len=MAX_LEN)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert int(tc["lengths"][0]) == int(jc["lengths"][0]) == 19
    ref = _flat(_np(jc))
    for path, leaf in _flat(tc).items():
        key = jax.tree_util.keystr(path)
        assert leaf.shape == ref[path].shape, key
        if any(k in key for k in ("wkv", "x_tm", "x_cm", "ssm", "conv")):
            np.testing.assert_allclose(leaf.numpy(), ref[path], **TOL,
                                       err_msg=key)


@pytest.mark.parametrize("name", ["rwkv6", "jamba"])
def test_prefill_plus_decode_equals_longer_prefill(weights, name):
    """The reference's ``test_prefill_plus_decode_equals_full_prefill`` on
    the port (lop_keep 1: exact attention; capacity factor 8: no MoE
    drops): prefill(S) + ``serve_step`` within 2e-2 of prefill(S + 1)
    relative to its largest logit, as there; the rwkv6 states after the
    step within 2e-5 of the longer prefill's."""
    _, cfg = PAIRS[name]
    cfg = cfg.replace(lop_keep=1.0, capacity_factor=8.0)
    tqp = weights[name][1]
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 21))).long()
    full, fc = teng.prefill(cfg, tqp, tokens, max_len=22)
    _, c = teng.prefill(cfg, tqp, tokens[:, :20], max_len=22)
    dec, c = teng.serve_step(cfg, tqp, c, tokens[:, 20:21])
    assert torch.isfinite(dec).all()
    err = float((dec - full).abs().max())
    assert err / (float(full.abs().max()) + 1e-9) < 2e-2, err
    if name == "rwkv6":
        for key in ("wkv", "x_tm", "x_cm"):
            np.testing.assert_allclose(c["layers"][key].numpy(),
                                       fc["layers"][key].numpy(), **TOL)
    assert torch.equal(c["lengths"], fc["lengths"])


# ---------------------------------------------------------------------------
# scheduler against the reference's lockstep
# ---------------------------------------------------------------------------

ARMS = [("rwkv6", True, False), ("rwkv6", True, True),
        ("jamba", True, False), ("jamba", False, False),
        ("jamba", True, True)]


@pytest.mark.parametrize("name,use_lop,sampled", ARMS,
                         ids=["rwkv6-greedy", "rwkv6-sampled", "jamba-lop",
                              "jamba-no-lop", "jamba-lop-sampled"])
def test_scheduler_matches_reference_lockstep(weights, engines, name,
                                              use_lop, sampled):
    """The reference's ``test_recurrent_family_uses_exact_length_prefill``
    scenario (prompts of 11 and 19 tokens, 5 new, 2 slots, max_len 63):
    each prompt prefilled whole at its exact length, and the port's
    Scheduler tokens equal the reference's ``lockstep_generate`` (and the
    port's own lockstep)."""
    jcfg, cfg = PAIRS[name]
    jqp, _ = weights[name]
    eng = engines[(name, use_lop)]
    sched = Scheduler(eng, n_slots=2, check_invariants=True)
    assert not sched.chunked and sched.prefix_store is None
    prompts = _prompts(cfg, [11, 19])
    sps = [SamplingParams(seed=rid, **SAMPLED) if sampled else None
           for rid in range(len(prompts))]
    for rid, p in enumerate(prompts):
        sched.submit(GenerateRequest(rid=rid, prompt=p, max_new_tokens=5,
                                     **({"sampling": sps[rid]} if sampled
                                        else {})))
    got = {r.rid: r.tokens for r in sched.run_to_completion()}
    assert len(sched.full_prefill_seconds) == len(prompts)
    jeng = _ref_engine(jcfg, jqp, use_lop, MAX_LEN)
    if not use_lop:
        # the reference's prefill never reads use_lop: the no-LOP engine
        # takes the LOP engine's compiled prefills instead of compiling
        # its own
        jeng._fns = _ref_engine(jcfg, jqp, True, MAX_LEN)._fns
    for rid, p in enumerate(prompts):
        jsp = (JSampling(seed=rid, **SAMPLED) if sampled else None)
        want = jlockstep(jcfg, jqp, p, 5, max_len=MAX_LEN, use_lop=use_lop,
                         sampling=jsp, engine=jeng)
        assert got[rid] == want, (rid, got[rid], want)
        assert got[rid] == lockstep_generate(eng, p, 5, sampling=sps[rid])


def test_transient_nan_on_rwkv_pool_matches_reference(weights, engines):
    """A NaN lane (decode call 1, lane 0) on a 2-lane rwkv6 pool, the
    port's and the reference's Scheduler under the same ``FaultPlan``:
    one fault event, recovered through the retry, and every stream equal
    to the reference's. The retry steps every lane's recurrent state once
    more, as the reference's does, so both streams part from the clean
    run after the fault."""
    jqp, _ = weights["rwkv6"]
    eng = engines[("rwkv6", True)]
    prompts = _prompts(RWKV, [11, 19])
    plan = dict(nan_logits=frozenset({(1, 0)}))
    streams = {}
    for label, fplan in (("clean", None), ("nan", plan)):
        sched = Scheduler(eng, n_slots=2, check_invariants=True)
        jsched = JScheduler(JRWKV, jqp, n_slots=2, max_len=MAX_LEN,
                            engine=_ref_engine(JRWKV, jqp, True, MAX_LEN))
        with faults.inject(faults.FaultPlan(**(fplan or {}))):
            for rid, p in enumerate(prompts):
                sched.submit(GenerateRequest(rid=rid, prompt=p,
                                             max_new_tokens=6))
            got = {r.rid: r.tokens for r in sched.run_to_completion()}
        with jfaults.inject(jfaults.FaultPlan(**(fplan or {}))):
            for rid, p in enumerate(prompts):
                jsched.submit(JRequest(rid=rid, prompt=p, max_new_tokens=6))
            want = {r.rid: r.tokens for r in jsched.run_to_completion()}
        assert got == want, label
        assert sched.fault_events == jsched.fault_events \
            == (label == "nan")
        assert sched.fault_recoveries == sched.fault_events
        streams[label] = got
    for rid in range(len(prompts)):
        assert streams["nan"][rid] != streams["clean"][rid], rid
        assert streams["nan"][rid][:2] == streams["clean"][rid][:2], rid
