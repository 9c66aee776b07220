"""The reference's fault-tolerance contracts (``tests/test_faults.py``)
replayed on the port, on ``bitnet-3b-reduced`` with the reference's
converted weights, on the CPU:

  * ``FaultPlan.random`` draws the reference's plan field for field, and
    ``inject`` scopes the counter-keyed injection points;
  * ``rollback_slot`` is bitwise the reference's on a converted pool;
  * a transient NaN is rewound and retried through the no-LOP step, and
    the streams equal the unfaulted lockstep streams; a sticky lane ends
    with reason "fault" and its slot serves again; a sampled lane's
    recovery reproduces the unfaulted same-seed stream;
  * deadlines fire in the queue, mid-decode and between prefill chunks
    (injected clock), and a bounded queue sheds the newest submit;
  * ``check_invariants`` runs after every step and catches a desync;
  * prefix-store faults: the insert and match counters fire where the
    reference's do, the injected bit flip lands on the reference's leaf,
    byte and bit, a corrupted interned page fails its checksum at the next
    match and the request prefills cold, a lookup outage degrades to a
    cold prefill, and tokens stay the unfaulted streams;
  * a lane whose drafts are never accepted trips the speculative watchdog
    and finishes through plain decode, lockstep-exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.bitnet_3b import REDUCED as JCFG
from repro.models.transformer import init_params as jinit
from repro.serving import cache as jcache
from repro.serving import faults as jfaults
from repro.serving.quantize import quantize_params as jquantize
from repro_torch.configs import get_config
from repro_torch.convert import from_numpy_tree
from repro_torch.serving import faults
from repro_torch.serving.api import (GenerateRequest, PooledEngine,
                                     SamplingParams)
from repro_torch.serving import cache
from repro_torch.serving.cache import rollback_slot
from repro_torch.serving.scheduler import Scheduler, lockstep_generate

torch.set_num_threads(1)

MAX_LEN = 63          # pool capacity 64 with the reduced lop_block of 32
CFG = get_config("bitnet-3b-reduced")


@pytest.fixture(scope="module")
def tqp():
    params, _ = jinit(JCFG, jax.random.PRNGKey(0))
    return from_numpy_tree(jax.tree.map(np.asarray,
                                        jquantize(JCFG, params)), "cpu")


@pytest.fixture(scope="module")
def engine(tqp):
    """One shared no-LOP engine: its retry is the plain decode path."""
    return PooledEngine(CFG, tqp, max_len=MAX_LEN, use_lop=False,
                        device="cpu")


def _prompts(lens, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab, (n,)).astype(np.int32) for n in lens]


def _sched(eng, **kw):
    return Scheduler(eng, n_slots=kw.pop("n_slots", 2),
                     check_invariants=True, **kw)


def _run(sched):
    return {r.rid: r for r in sched.run_to_completion()}


# ---------------------------------------------------------------------------
# The plan and its injection points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,kw", [
    (7, dict(n_decode_calls=50, n_lanes=4, nan_events=3, sticky_lanes=1,
             page_flips=2, lookup_fails=2, slow_steps=2, slow_s=0.001)),
    (8, dict(n_decode_calls=50, n_lanes=4, nan_events=3, sticky_lanes=1,
             page_flips=2, lookup_fails=2, slow_steps=2, slow_s=0.001)),
    (0, dict(n_decode_calls=5, n_lanes=2)),
    (123, dict(n_decode_calls=1, n_lanes=8, nan_events=4, sticky_lanes=9,
               slow_steps=3))])
def test_fault_plan_random_matches_reference(seed, kw):
    got = faults.FaultPlan.random(seed, **kw)
    want = jfaults.FaultPlan.random(seed, **kw)
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got == faults.FaultPlan.random(seed, **kw)


def test_inject_scopes_and_rejects_nesting():
    assert faults.active() is None and faults.state() is None
    plan = faults.FaultPlan(nan_logits=frozenset({(0, 0)}),
                            sticky_nan_lanes=frozenset({3}),
                            slow_steps=frozenset({1}), slow_s=1e-4)
    with faults.inject(plan) as st:
        assert faults.active() is plan and faults.state() is st
        with pytest.raises(RuntimeError):
            with faults.inject(plan):
                pass
        add = faults.decode_fault_add(2)              # call 0: lane 0
        assert np.isnan(add[0]) and np.isfinite(add[1])
        add = faults.decode_fault_add(4)              # call 1: sticky 3
        assert np.isnan(add).tolist() == [False, False, False, True]
        assert st.injected_slow == 1
        retry = faults.retry_fault_add(4)             # sticky only
        assert np.isnan(retry).tolist() == [False, False, False, True]
        assert st.decode_calls == 2 and st.injected_nan == 2
    assert faults.active() is None
    assert faults.decode_fault_add(2) is None         # production fast path
    assert faults.retry_fault_add(2) is None


# ---------------------------------------------------------------------------
# rollback_slot against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("slot,n", [(1, 3), (0, 1), (2, 40)])
def test_rollback_slot_bitwise_reference(slot, n):
    rng = np.random.default_rng(slot * 100 + n)
    pool = jax.tree.map(np.asarray, jcache.init_cache_pool(JCFG, 3, MAX_LEN))
    for key, leaf in pool["layers"].items():
        if leaf.dtype == np.float32:
            pool["layers"][key] = rng.random(leaf.shape).astype(np.float32)
        else:
            pool["layers"][key] = rng.integers(
                np.iinfo(leaf.dtype).min, np.iinfo(leaf.dtype).max,
                leaf.shape).astype(leaf.dtype)
    pool["lengths"] = np.array([20, 33, 17], np.int32)
    pool["sample_step"] = np.array([5, 7, 2], np.int32)
    pool["seed"] = np.array([1, 2, 3], np.int32)
    pool["active"] = np.array([True, True, False])
    want = jax.tree.map(np.asarray, jcache.rollback_slot(
        jax.tree.map(jnp.asarray, pool), slot, n))
    got = rollback_slot(from_numpy_tree(pool, "cpu"), slot, n)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert set(flat_g) == {p for p, _ in flat_w}
    for path, leaf in flat_w:
        assert np.array_equal(flat_g[path].numpy(), leaf), path


# ---------------------------------------------------------------------------
# NaN guard → rollback → no-LOP retry
# ---------------------------------------------------------------------------

def test_transient_nan_recovers_lockstep_exact(engine):
    prompts = _prompts([12, 27, 9])
    plan = faults.FaultPlan(nan_logits=frozenset({(2, 0), (4, 1)}))
    with faults.inject(plan) as st:
        sched = _sched(engine)
        for rid, p in enumerate(prompts):
            sched.submit(GenerateRequest(rid=rid, prompt=p,
                                         max_new_tokens=6))
        res = _run(sched)
        assert st.injected_nan >= 1
    assert sched.fault_events >= 1
    assert sched.fault_recoveries == sched.fault_events
    assert sched.fault_finishes == 0
    for rid, p in enumerate(prompts):
        assert res[rid].finish_reason == "length"
        assert res[rid].tokens == lockstep_generate(engine, p, 6), rid


def test_sticky_nan_lane_finishes_with_fault(engine):
    p0, p1 = _prompts([12, 9], seed=7)
    with faults.inject(faults.FaultPlan(sticky_nan_lanes=frozenset({0}))):
        sched = _sched(engine, n_slots=1)
        sched.submit(GenerateRequest(rid=0, prompt=p0, max_new_tokens=6))
        res = _run(sched)
    assert res[0].finish_reason == "fault"
    assert res[0].tokens == lockstep_generate(engine, p0, 1)
    assert sched.fault_finishes == 1 and sched.fault_events == 1
    assert sched.n_active == 0 and len(sched._free) == 1
    sched.submit(GenerateRequest(rid=1, prompt=p1, max_new_tokens=5))
    assert _run(sched)[1].tokens == lockstep_generate(engine, p1, 5)


def test_sampled_recovery_reproduces_unfaulted_stream(engine):
    (p,) = _prompts([12])
    sp = SamplingParams(temperature=0.8, top_k=20, seed=7)
    runs = []
    for plan in (faults.FaultPlan(),
                 faults.FaultPlan(nan_logits=frozenset({(1, 0)}))):
        with faults.inject(plan):
            sched = _sched(engine, n_slots=1)
            sched.submit(GenerateRequest(rid=0, prompt=p, max_new_tokens=6,
                                         sampling=sp))
            runs.append(sched.run_to_completion()[0].tokens)
    assert runs[0] == runs[1] == lockstep_generate(engine, p, 6, sampling=sp)
    assert sched.fault_recoveries == 1


def test_lop_engine_recovers_through_dense_retry(tqp):
    """The production shape: a LOP server whose retry runs dense decode
    attention; the recovered lane finishes normally."""
    eng = PooledEngine(CFG, tqp, max_len=MAX_LEN, device="cpu")
    prompts = _prompts([20, 11])
    with faults.inject(faults.FaultPlan(nan_logits=frozenset({(1, 1)}))):
        sched = _sched(eng)
        for rid, p in enumerate(prompts):
            sched.submit(GenerateRequest(rid=rid, prompt=p,
                                         max_new_tokens=5))
        res = _run(sched)
    assert sched.fault_events == sched.fault_recoveries == 1
    assert sched.fault_finishes == 0
    assert all(r.finish_reason == "length" and len(r.tokens) == 5
               for r in res.values())


def test_check_invariants_catches_a_desync(engine):
    (p,) = _prompts([10], seed=5)
    sched = _sched(engine, n_slots=2)
    sched.submit(GenerateRequest(rid=0, prompt=p, max_new_tokens=4))
    sched.admit()
    sched.step()
    sched.check_invariants()
    sched.pool["lengths"][0] += 1
    with pytest.raises(AssertionError):
        sched.check_invariants()
    sched.pool["lengths"][0] -= 1
    sched.pool["active"][1] = True
    with pytest.raises(AssertionError):
        sched.check_invariants()


# ---------------------------------------------------------------------------
# Deadlines and admission control
# ---------------------------------------------------------------------------

def test_deadline_expired_in_queue_never_takes_a_lane(engine):
    p0, p1 = _prompts([10, 10], seed=17)
    t = [0.0]
    sched = _sched(engine, n_slots=1, clock=lambda: t[0])
    sched.submit(GenerateRequest(rid=0, prompt=p0, max_new_tokens=4,
                                 deadline_ms=50.0))
    sched.submit(GenerateRequest(rid=1, prompt=p1, max_new_tokens=4))
    t[0] = 0.2
    res = _run(sched)
    assert res[0].finish_reason == "deadline" and res[0].tokens == []
    assert res[1].finish_reason == "length"
    assert sched.deadline_count == 1


def test_deadline_mid_decode_delivers_partial_stream(engine):
    (p,) = _prompts([10], seed=19)
    t = [0.0]
    sched = _sched(engine, n_slots=1, clock=lambda: t[0])
    sched.submit(GenerateRequest(rid=0, prompt=p, max_new_tokens=10,
                                 deadline_ms=45.0))
    steps = 0
    while sched.has_work():
        sched.admit()
        sched.step()
        t[0] += 0.01
        steps += 1
        assert steps < 50, "deadline never fired"
    res = sched.results[0]
    assert res.finish_reason == "deadline"
    assert 1 <= len(res.tokens) < 10
    assert res.tokens == lockstep_generate(engine, p, 10)[:len(res.tokens)]
    assert sched.n_active == 0 and len(sched._free) == 1


def test_deadline_between_prefill_chunks_frees_reserved_lane(engine):
    (p,) = _prompts([60], seed=21)        # two 32-token chunks
    t = [0.0]
    sched = _sched(engine, n_slots=1, clock=lambda: t[0])
    sched.submit(GenerateRequest(rid=0, prompt=p, max_new_tokens=2,
                                 deadline_ms=5.0))
    sched.admit()
    sched.step()                          # chunk 0 of 2, inside the budget
    assert sched.n_prefilling == 1
    t[0] = 0.01
    sched.step()                          # expired between the chunks
    res = sched.results[0]
    assert res.finish_reason == "deadline" and res.tokens == []
    assert sched.n_prefilling == 0 and len(sched._free) == 1
    assert sched.deadline_count == 1 and not sched.has_work()


def test_bounded_queue_sheds_newest(engine):
    prompts = _prompts([10, 12, 9, 11], seed=23)
    sched = _sched(engine, n_slots=1, max_queue=3)
    oks = [sched.submit(GenerateRequest(rid=i, prompt=p, max_new_tokens=3))
           for i, p in enumerate(prompts)]
    assert oks == [True, True, True, False]
    assert sched.shed_count == 1 and sched.queue_depth_peak == 3
    res = _run(sched)
    assert res[3].finish_reason == "shed" and res[3].tokens == []
    assert all(res[i].finish_reason == "length" for i in range(3))


# ---------------------------------------------------------------------------
# Prefix-store faults: checksums and lookup outages
# ---------------------------------------------------------------------------

def test_prefix_injection_points_match_reference():
    plan = dict(seed=4, page_bitflips=frozenset({1, 3}),
                lookup_failures=frozenset({0, 2}))
    with faults.inject(faults.FaultPlan(**plan)) as st, \
            jfaults.inject(jfaults.FaultPlan(**plan)) as jst:
        for _ in range(5):
            got, want = faults.page_corruption_rng(), \
                jfaults.page_corruption_rng()
            assert (got is None) == (want is None)
            if got is not None:
                assert got.integers(0, 2 ** 31, 4).tolist() == \
                    want.integers(0, 2 ** 31, 4).tolist()
            assert faults.lookup_fails() == jfaults.lookup_fails()
        for name in ("insert_calls", "match_calls", "injected_flips",
                     "injected_lookup_failures"):
            assert getattr(st, name) == getattr(jst, name) > 0, name
    assert faults.page_corruption_rng() is None
    assert not faults.lookup_fails()


@pytest.mark.parametrize("seed", [3, 11, 12])
def test_injected_flip_matches_reference(engine, seed):
    """The flipped pages of one node equal the reference's
    ``_flip_one_bit`` on the same pages with the same generator: the same
    leaf, byte and bit."""
    (p,) = _prompts([40], seed=seed)
    _, c = engine.prefill(p[None])
    pages = cache._slice_pages(c, 0, 32)
    want = jcache._flip_one_bit(jax.tree.map(
        lambda t: jnp.asarray(t.numpy()), pages),
        np.random.default_rng((seed, 0)))
    clean = {k: v.clone() for k, v in pages["layers"].items()}
    cache._flip_one_bit(pages, np.random.default_rng((seed, 0)))
    changed = [k for k in clean if not torch.equal(pages["layers"][k],
                                                   clean[k])]
    assert len(changed) == 1
    for key, leaf in want["layers"].items():
        assert np.array_equal(pages["layers"][key].numpy(),
                              np.asarray(leaf)), key


def test_corrupted_prefix_page_fails_checksum_and_falls_back(engine):
    """A bit flipped in an interned page after its checksum is caught at
    the next match: the corrupt node is dropped, the request prefills
    cold, the prefix is interned again and serves the next hit cleanly;
    tokens are never wrong."""
    (p,) = _prompts([40], seed=13)
    plan = faults.FaultPlan(seed=3, page_bitflips=frozenset({0}))
    with faults.inject(plan) as st:
        sched = _sched(engine, n_slots=1)
        for rid in range(3):
            sched.submit(GenerateRequest(rid=rid, prompt=p,
                                         max_new_tokens=4))
        res = _run(sched)
        assert st.injected_flips == 1
    store = sched.prefix_store
    assert store.checksum_failures == 1
    # rid 1 met the corrupt node → cold prefill and intern; rid 2 hits
    assert sched.prefix_hits == 1
    assert [res[r].cached_len for r in range(3)] == [0, 0, 32]
    ref = lockstep_generate(engine, p, 4)
    for rid in range(3):
        assert res[rid].tokens == ref, rid
    store.check_invariants()


def test_lookup_failure_degrades_to_cold_prefill(engine):
    (p,) = _prompts([40], seed=15)
    with faults.inject(faults.FaultPlan(lookup_failures=frozenset({1}))):
        sched = _sched(engine, n_slots=1)
        for rid in range(3):
            sched.submit(GenerateRequest(rid=rid, prompt=p,
                                         max_new_tokens=4))
        res = _run(sched)
    assert sched.prefix_lookup_failures == 1
    assert sched.prefix_hits == 1              # rid 2 still hits
    ref = lockstep_generate(engine, p, 4)
    for rid in range(3):
        assert res[rid].tokens == ref, rid


# ---------------------------------------------------------------------------
# Speculative watchdog
# ---------------------------------------------------------------------------

def test_spec_watchdog_disables_hopeless_drafting(tqp):
    """A lane whose drafts never match the verifier trips the watchdog
    after ``spec_watchdog`` zero-accept rounds and finishes through plain
    decode, lockstep-exact (a round emits the verifier's own tokens)."""
    (p,) = _prompts([10], seed=25)
    eng = PooledEngine(CFG, tqp, max_len=MAX_LEN, use_lop=False,
                       device="cpu")
    orig = eng.draft

    def bad_draft(pool, tokens, temps, tks, tps):
        toks, pool = orig(pool, tokens, temps, tks, tps)
        return (toks + 1) % CFG.vocab, pool     # always-wrong proposals

    eng.draft = bad_draft
    sched = Scheduler(eng, n_slots=1, spec_decode=True, gamma=3,
                      spec_watchdog=2, check_invariants=True)
    sched.submit(GenerateRequest(rid=0, prompt=p, max_new_tokens=10))
    res = sched.run_to_completion()[0]
    assert sched.spec_watchdog_trips == 1
    assert sched.spec_rounds == 2              # the two zero-accept rounds
    assert sched.spec_accepted == 0
    assert sched.decode_launches > 0           # the plain-decode tail
    assert res.tokens == lockstep_generate(eng, p, 10)
