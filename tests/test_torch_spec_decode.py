"""Self-speculative decoding on the port (``tests/test_spec_decode.py``'s
contracts that a dense config runs), on ``bitnet-3b-reduced`` with the
reference's converted weights, on the CPU:

  * the engine's round — γ draft steps, one verify chunk a lane,
    ``sample_block``, the rollback of the rejected tail — is the reference
    engine's on the same pool (tokens and integer pool leaves bitwise,
    logits and scales at 2e-5), a greedy and a sampled lane with LOP on;
  * one greedy no-LOP speculative scheduler run is the reference
    scheduler's, token for token and counter for counter;
  * greedy and sampled speculation with ``use_lop=False`` emit the
    lockstep stream; speculative and plain scheduling emit the same stream
    with fewer full-model decode launches; with LOP on every request
    completes and the counters close;
  * γ shrinks at the capacity edge, eos and stop fire inside an accepted
    window, a cancellation mid-round keeps a clean prefix and the lane
    serves again;
  * an engine without ``supports_speculative`` decodes plainly; γ < 1 is
    rejected;
  * ``rollback`` inverts speculative writes bitwise (a grid of γ and j),
    touches one lane only, and rolling back into cloned prefix pages
    leaves the store's pages intact.

The reference's vlm case is held in ``tests/test_torch_vlm.py``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.bitnet_3b import REDUCED as JCFG
from repro.models.transformer import init_params as jinit
from repro.serving.api import GenerateRequest as JRequest
from repro.serving.api import PooledEngine as JEngine
from repro.serving.api import SamplingParams as JSamplingParams
from repro.serving.quantize import quantize_params as jquantize
from repro.serving.scheduler import Scheduler as JScheduler
from repro_torch.configs import get_config
from repro_torch.convert import from_numpy_tree
from repro_torch.serving import cache
from repro_torch.serving.api import (CancelToken, ExistingPrefix,
                                     GenerateRequest, PooledEngine,
                                     SamplingParams)
from repro_torch.serving.scheduler import Scheduler, lockstep_generate

torch.set_num_threads(1)

MAX_LEN = 63          # pool capacity 64 with the reduced lop_block of 32
CFG = get_config("bitnet-3b-reduced")
SAMPLED = (0.9, 8, 1.0)         # temperature, top-k, top-p


@pytest.fixture(scope="module")
def weights():
    params, _ = jinit(JCFG, jax.random.PRNGKey(0))
    jqp = jquantize(JCFG, params)
    return jqp, from_numpy_tree(jax.tree.map(np.asarray, jqp), "cpu")


@pytest.fixture(scope="module")
def eng(weights):
    """One shared no-LOP engine: speculation then emits the plain-decode
    stream exactly."""
    return PooledEngine(CFG, weights[1], max_len=MAX_LEN, use_lop=False,
                        device="cpu")


@pytest.fixture(scope="module")
def deep(weights):
    """A no-LOP engine whose draft runs every layer: its drafts are the
    plain decode's tokens, so rounds accept and a finish or a cancellation
    lands inside an accepted window."""
    return PooledEngine(CFG, weights[1], max_len=MAX_LEN, use_lop=False,
                        device="cpu", draft_layers=CFG.n_layers)


def _prompts(lens, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab, (n,)).astype(np.int32) for n in lens]


def _run(eng, reqs, *, gamma=4, n_slots=2, **kw):
    sched = Scheduler(eng, n_slots=n_slots, spec_decode=True, gamma=gamma,
                      check_invariants=True, **kw)
    for r in reqs:
        sched.submit(r)
    return sched, {r.rid: r for r in sched.run_to_completion()}


def _tensors(tree, prefix=""):
    for name, val in sorted(tree.items()):
        if isinstance(val, dict):
            yield from _tensors(val, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", val


def _assert_pools_equal(jpool, tpool, where):
    """Integer leaves (K/V, feature rows) and per-lane vectors bitwise; the
    f32 absmax scales at rtol = atol = 2e-5 (the activations they scale
    pass through other f32 op orders in the two frameworks)."""
    want = dict(_tensors(jax.tree.map(np.asarray, jpool)))
    got = dict(_tensors(tpool))
    assert sorted(got) == sorted(want)
    for name, leaf in want.items():
        if leaf.dtype == np.float32:
            np.testing.assert_allclose(got[name].numpy(), leaf, rtol=2e-5,
                                       atol=2e-5, err_msg=f"{where} {name}")
        else:
            np.testing.assert_array_equal(got[name].numpy(), leaf,
                                          err_msg=f"{where} {name}")


# ---------------------------------------------------------------------------
# the engine's round against the reference engine's
# ---------------------------------------------------------------------------

def test_spec_round_matches_reference_engine(weights):
    """Two rounds of γ = 3 on a 3-slot LOP pool with lanes 0 (greedy) and
    2 (sampled) live: the
    draft tokens, ``sample_block``'s targets and every pool leaf after
    each draft, verify and rollback equal the reference engine's (scales
    and verify logits within rtol = atol = 2e-5, the reference's own
    prefill tolerance)."""
    jqp, tqp = weights
    jeng = JEngine(JCFG, jqp, max_len=MAX_LEN)
    teng = PooledEngine(CFG, tqp, max_len=MAX_LEN, device="cpu")
    assert (teng.draft_layers, teng.draft_k) == (jeng.draft_layers,
                                                 jeng.draft_k) == (1, 1)
    jpool = jeng.init_pool(3)
    nxt = np.zeros((3, 1), np.int32)
    emitted = {}
    for slot, p in zip((0, 2), _prompts((20, 29), seed=1)):
        logits, one = jeng.prefill(p[None], len(p), {})
        jpool = jeng.insert(jpool, slot, one)
        jpool = jeng.set_sampling_state(jpool, slot, 10 + slot, 1)
        nxt[slot, 0] = int(np.argmax(np.asarray(logits)[0]))
        emitted[slot] = 1
    tpool = from_numpy_tree(jax.tree.map(np.asarray, jpool), "cpu")
    temps = np.zeros(3, np.float32)
    tks = np.zeros(3, np.int32)
    tps = np.ones(3, np.float32)
    temps[2], tks[2], tps[2] = SAMPLED
    g = 3
    for rnd in range(2):
        cur = nxt.copy()
        drafts = {0: [], 2: []}
        for i in range(g):
            jt, jpool = jeng.draft(jpool, cur, temps, tks, tps)
            tt, tpool = teng.draft(tpool, cur, temps, tks, tps)
            assert tt[[0, 2]].tolist() == np.asarray(jt)[[0, 2]].tolist()
            _assert_pools_equal(jpool, tpool, (rnd, "draft", i))
            for s in (0, 2):
                drafts[s].append(int(tt[s]))
                cur[s, 0] = tt[s]
        for s in (0, 2):
            start = int(tpool["lengths"][s]) - g
            block = np.concatenate([nxt[s], drafts[s]]).astype(
                np.int32)[None]
            jl, jpool = jeng.verify_chunk(jpool, s, block, start)
            tl, tpool = teng.verify_chunk(tpool, s, block, start)
            assert tl.shape == (1, g + 1, CFG.vocab_padded)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       rtol=2e-5, atol=2e-5)
            _assert_pools_equal(jpool, tpool, (rnd, "verify", s))
            sp = SamplingParams(*SAMPLED, seed=10 + s) \
                if temps[s] > 0 else None
            jsp = JSamplingParams(*SAMPLED, seed=10 + s) \
                if temps[s] > 0 else None
            targets = teng.sample_block(tl, sp, emitted[s])
            assert targets.tolist() == np.asarray(
                jeng.sample_block(jl, jsp, emitted[s])).tolist()
            j = 0
            while j < g and drafts[s][j] == int(targets[j]):
                j += 1
            if j < g:
                jpool = jeng.rollback(jpool, s, g - j)
                tpool = teng.rollback(tpool, s, g - j)
                _assert_pools_equal(jpool, tpool, (rnd, "rollback", s))
            emitted[s] += j + 1
            nxt[s, 0] = targets[j]


def test_greedy_spec_scheduler_matches_reference(weights, eng):
    jqp, _ = weights
    prompts = _prompts((9, 21))
    sched, res = _run(eng, [GenerateRequest(rid=i, prompt=p,
                                            max_new_tokens=12)
                            for i, p in enumerate(prompts)])
    jsched = JScheduler(JCFG, jqp, n_slots=2, max_len=MAX_LEN, use_lop=False,
                        spec_decode=True, gamma=4)
    for i, p in enumerate(prompts):
        jsched.submit(JRequest(rid=i, prompt=p, max_new_tokens=12))
    jres = {r.rid: r for r in jsched.run_to_completion()}
    assert sched.spec and sched.spec_rounds > 0
    for name in ("spec_rounds", "spec_drafted", "spec_accepted",
                 "spec_emitted", "spec_verify_launches", "draft_launches",
                 "decode_launches", "spec_watchdog_trips"):
        assert getattr(sched, name) == getattr(jsched, name), name
    for i, p in enumerate(prompts):
        assert res[i].tokens == [int(t) for t in jres[i].tokens]
        assert res[i].tokens == lockstep_generate(eng, p, 12), i


# ---------------------------------------------------------------------------
# token identity against the port's lockstep
# ---------------------------------------------------------------------------

def test_sampled_spec_matches_lockstep(eng):
    """A seeded sampled request emits its non-speculative stream: draft i
    and verify row i draw under the same emission-indexed key."""
    prompts = _prompts((9, 21))
    sp = SamplingParams(temperature=0.9, top_k=8, seed=5)
    sched, res = _run(eng, [GenerateRequest(rid=i, prompt=p,
                                            max_new_tokens=10, sampling=sp)
                            for i, p in enumerate(prompts)], gamma=3,
                      spec_watchdog=99)
    assert sched.spec_rounds > 0
    for i, p in enumerate(prompts):
        assert res[i].tokens == lockstep_generate(eng, p, 10, sampling=sp)


def test_spec_matches_nonspec_scheduler(eng):
    prompts = _prompts((12, 30), seed=11)

    def reqs():
        return [GenerateRequest(rid=i, prompt=p, max_new_tokens=8)
                for i, p in enumerate(prompts)]

    spec, spec_res = _run(eng, reqs())
    plain = Scheduler(eng, n_slots=2)
    for r in reqs():
        plain.submit(r)
    plain_res = {r.rid: r for r in plain.run_to_completion()}
    for i in range(len(prompts)):
        assert spec_res[i].tokens == plain_res[i].tokens
    assert spec.spec_verify_launches > 0
    assert spec.decode_launches < plain.decode_launches
    assert plain.spec_rounds == 0


def test_spec_with_lop_on_completes(weights):
    """With LOP on, speculation emits the verifier's exact-attention
    stream (not the screened plain stream, DESIGN.md
    §Speculative-decoding): every request reaches its budget and the
    counters close."""
    lop = PooledEngine(CFG, weights[1], max_len=MAX_LEN, device="cpu")
    prompts = _prompts((9, 21))
    sched, res = _run(lop, [GenerateRequest(rid=i, prompt=p,
                                            max_new_tokens=9)
                            for i, p in enumerate(prompts)], gamma=3,
                      spec_watchdog=99)
    assert sched.spec_rounds > 0
    for i in range(len(prompts)):
        assert len(res[i].tokens) == 9 and res[i].finish_reason == "length"
    emitted = sum(len(r.tokens) for r in res.values())
    assert len(prompts) + sched.spec_emitted + sched.decode_launches \
        * len(prompts) >= emitted >= len(prompts) + sched.spec_emitted
    assert sched.spec_accepted <= sched.spec_drafted


# ---------------------------------------------------------------------------
# capacity clamp, finishes inside the window, cancel mid-round
# ---------------------------------------------------------------------------

def test_gamma_shrinks_at_capacity_boundary(eng):
    (prompt,) = _prompts((40,), seed=13)
    gen = 64 - 40            # need == pool capacity exactly
    sched, res = _run(eng, [GenerateRequest(rid=0, prompt=prompt,
                                            max_new_tokens=gen)],
                      gamma=8, n_slots=1, spec_watchdog=99)
    assert res[0].tokens == lockstep_generate(eng, prompt, gen)
    assert res[0].finish_reason == "length"
    # some round ran with γ shrunk below 8 (the budget or the capacity)
    assert 0 < sched.spec_drafted < 8 * sched.spec_rounds


def test_eos_and_stop_inside_accepted_window(deep):
    """An eos (the stream's first new token after position 2) or a stop
    sequence landing inside an accepted window finishes the lane there;
    the tokens past it are dropped."""
    (prompt,) = _prompts((15,), seed=18)
    ref = lockstep_generate(deep, prompt, 16)
    cut = next(k for k in range(2, len(ref)) if ref[k] not in ref[:k])
    sched, res = _run(deep, [GenerateRequest(rid=0, prompt=prompt,
                                             max_new_tokens=16,
                                             eos_id=ref[cut])], n_slots=1)
    assert sched.spec_accepted > 0
    assert res[0].tokens == ref[:cut + 1]
    assert res[0].finish_reason == "eos"
    sched, res = _run(deep, [GenerateRequest(rid=0, prompt=prompt,
                                             max_new_tokens=16,
                                             stop=(tuple(ref[cut - 1:
                                                             cut + 1]),))],
                      n_slots=1)
    assert sched.spec_accepted > 0
    assert res[0].tokens == ref[:cut + 1]
    assert res[0].finish_reason == "stop"


def test_cancel_token_fired_mid_spec_round(deep):
    """A cancellation fired from ``on_token`` between a round's emissions
    retires the lane inside the round: the delivered tokens are a prefix
    of the lockstep stream, the unemitted window is rewound, and the lane
    then serves a fresh request exactly."""
    p0, p1 = _prompts((15, 9), seed=37)
    ref = lockstep_generate(deep, p0, 12)
    tok = CancelToken()

    def on_token(sr):
        if sr.index >= 1:
            tok.cancel()

    sched = Scheduler(deep, n_slots=1, spec_decode=True, gamma=4,
                      check_invariants=True)
    sched.submit(GenerateRequest(rid=0, prompt=p0, max_new_tokens=12,
                                 cancel=tok, on_token=on_token))
    res = {r.rid: r for r in sched.run_to_completion()}
    assert sched.spec_rounds >= 1 and sched.spec_accepted > 0
    assert res[0].finish_reason == "cancelled"
    assert 2 <= len(res[0].tokens) < 12
    assert res[0].tokens == ref[:len(res[0].tokens)]
    assert sched.n_active == 0 and len(sched._free) == 1
    sched.submit(GenerateRequest(rid=1, prompt=p1, max_new_tokens=8))
    res = {r.rid: r for r in sched.run_to_completion()}
    assert res[1].tokens == lockstep_generate(deep, p1, 8)


def test_spec_degrades_without_capability_and_checks_gamma(weights):
    engine = PooledEngine(CFG, weights[1], max_len=MAX_LEN, use_lop=False,
                          device="cpu")
    engine.supports_speculative = False
    (p,) = _prompts((9,))
    sched = Scheduler(engine, n_slots=1, spec_decode=True, gamma=4)
    assert not sched.spec
    sched.submit(GenerateRequest(rid=0, prompt=p, max_new_tokens=6))
    assert sched.run_to_completion()[0].tokens == lockstep_generate(
        engine, p, 6)
    assert sched.spec_rounds == 0
    with pytest.raises(ValueError):
        Scheduler(engine, n_slots=1, spec_decode=True, gamma=0)


# ---------------------------------------------------------------------------
# rollback: speculative writes are exactly invertible
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rollback_rig(eng):
    """``build(n)``: a lane inserted from one prefill that then decoded
    ``n`` predetermined sampled tokens — the writes a rollback inverts."""
    (prompt,) = _prompts((10,), seed=23)
    _, req_cache = eng.prefill(prompt[None])
    params = (np.asarray([0.8], np.float32), np.asarray([0], np.int32),
              np.asarray([1.0], np.float32))
    feed = np.random.default_rng(29).integers(0, CFG.vocab, (8,)).astype(
        np.int32)

    def build(n_steps):
        pool = eng.init_pool(1)
        pool = eng.insert(pool, 0, req_cache)
        pool = eng.set_sampling_state(pool, 0, 5, 1)
        for t in feed[:n_steps]:
            _, pool = eng.decode_step(pool, np.asarray([[t]], np.int32),
                                      *params)
        return pool

    return build


@pytest.mark.parametrize("gamma,j", [(1, 0), (1, 1), (3, 1), (4, 4),
                                     (6, 2)])
def test_rollback_inverts_decode_writes(eng, rollback_rig, gamma, j):
    rolled = eng.rollback(rollback_rig(gamma), 0, j)
    want = dict(_tensors(rollback_rig(gamma - j)))
    got = dict(_tensors(rolled))
    assert sorted(got) == sorted(want)
    for name, leaf in want.items():
        assert torch.equal(got[name], leaf), name


def test_rollback_into_interned_prefix_leaves_store_pages_intact(eng):
    """Rolling a lane back into pages cloned from the store rewrites only
    the lane: the store's pages, assembled again, are bitwise as before
    (they are clones, never views of a lane), and verify clean."""
    store = cache.PrefixStore(eng.prefix_block)
    (prompt,) = _prompts((40,), seed=43)
    _, c = eng.prefill(prompt[None])
    n = len(prompt) // store.block * store.block
    node = store.insert(prompt[:n], c)
    assert node is not None and node.n_tokens == n
    snap = {k: v.clone() for k, v in store.assemble(node)["layers"].items()}
    pool = eng.init_pool(1)
    pool = eng.bulk_insert(pool, [0], ExistingPrefix(store.assemble(node), n))
    pool = eng.rollback(pool, 0, 5)          # back INTO the interned region
    assert int(pool["lengths"][0]) == n - 5
    for key, leaf in store.assemble(node)["layers"].items():
        assert torch.equal(leaf, snap[key]), key
    assert store.match(prompt) == (n, node)
    assert store.checksum_failures == 0
    store.check_invariants()


def test_rollback_slot_targets_one_lane(eng):
    p0, p1 = _prompts((10, 14), seed=31)
    _, c0 = eng.prefill(p0[None])
    _, c1 = eng.prefill(p1[None])
    pool = eng.init_pool(2)
    pool = eng.insert(pool, 0, c0)
    pool = eng.insert(pool, 1, c1)
    before = {k: v.clone() for k, v in _tensors(cache.extract_slot(pool, 1))}
    pool = eng.rollback(pool, 0, 3)
    assert pool["lengths"].tolist() == [len(p0) - 3, len(p1)]
    for name, leaf in _tensors(cache.extract_slot(pool, 1)):
        assert torch.equal(leaf, before[name]), name


def test_request_gamma_sets_the_round(eng):
    """A request's ``sampling.gamma`` (the wire's ``gamma``) sets its
    rounds' draft length below the scheduler's; the stream is still the
    lockstep one; a negative one is refused at submit."""
    (p,) = _prompts((13,))
    sp = SamplingParams(gamma=2)
    sched, res = _run(eng, [GenerateRequest(rid=0, prompt=p,
                                            max_new_tokens=9, sampling=sp)],
                      gamma=4, n_slots=1, spec_watchdog=99)
    assert sched.spec_rounds > 0
    assert sched.spec_drafted == sched.draft_launches <= 2 * sched.spec_rounds
    assert res[0].tokens == lockstep_generate(eng, p, 9)
    with pytest.raises(ValueError, match="gamma"):
        Scheduler(eng, n_slots=1, spec_decode=True).submit(GenerateRequest(
            rid=1, prompt=p, max_new_tokens=4,
            sampling=SamplingParams(gamma=-1)))
