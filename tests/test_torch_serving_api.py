"""The reference's serving-API contracts (``tests/test_serving_api.py``)
replayed on the port, on ``bitnet-3b-reduced`` with the reference's
converted weights, on the CPU:

  * a seeded sampled request decodes the same tokens alone
    (``lockstep_generate``) or sharing the pool with greedy and other
    sampled requests;
  * the port's sampled ``lockstep_generate`` equals the reference's, token
    for token, for two seeds, LOP on and off;
  * stop sequences retire a lane mid-decode (pinned to the written
    contract: stop after the 4th token, tokens == ref[:4]);
  * cancellation while queued and mid-decode, and the freed lane serves
    again;
  * ``on_token`` streams every token in order, ``finished`` on the last.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.bitnet_3b import REDUCED as JCFG
from repro.models.transformer import init_params as jinit
from repro.serving.api import SamplingParams as JSamplingParams
from repro.serving.quantize import quantize_params as jquantize
from repro.serving.scheduler import lockstep_generate as jlockstep
from repro_torch.configs import get_config
from repro_torch.convert import from_numpy_tree
from repro_torch.serving.api import (CancelToken, GenerateRequest,
                                     PooledEngine, SamplingParams, StepResult)
from repro_torch.serving.scheduler import Scheduler, lockstep_generate

torch.set_num_threads(1)

MAX_LEN = 63          # pool capacity 64 with the reduced lop_block of 32
CFG = get_config("bitnet-3b-reduced")


@pytest.fixture(scope="module")
def weights():
    params, _ = jinit(JCFG, jax.random.PRNGKey(0))
    jqp = jquantize(JCFG, params)
    return jqp, from_numpy_tree(jax.tree.map(np.asarray, jqp), "cpu")


@pytest.fixture(scope="module")
def eng(weights):
    return PooledEngine(CFG, weights[1], max_len=MAX_LEN, device="cpu")


def _prompts(lens, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab, (n,)).astype(np.int32) for n in lens]


def _run(sched):
    return {r.rid: r for r in sched.run_to_completion()}


@pytest.mark.parametrize("use_lop", [True, False])
@pytest.mark.parametrize("seed", [5, 99])
def test_sampled_lockstep_matches_reference(weights, use_lop, seed):
    jqp, tqp = weights
    eng = PooledEngine(CFG, tqp, max_len=MAX_LEN, use_lop=use_lop,
                       device="cpu")
    (p,) = _prompts([14], seed=seed)
    kw = dict(temperature=0.8, top_k=20, top_p=0.95, seed=seed)
    want = jlockstep(JCFG, jqp, p, 8, max_len=MAX_LEN, use_lop=use_lop,
                     sampling=JSamplingParams(**kw))
    assert lockstep_generate(eng, p, 8, sampling=SamplingParams(**kw)) == want


def test_sampled_fixed_seed_pool_equals_lockstep(eng):
    prompts = _prompts([14, 25, 8], seed=21)
    sps = [SamplingParams(temperature=0.8, top_k=8, seed=5),
           SamplingParams(),                     # greedy lane in the mix
           SamplingParams(temperature=1.2, top_p=0.9, seed=99)]
    sched = Scheduler(eng, n_slots=2, check_invariants=True)
    for rid, (p, sp) in enumerate(zip(prompts, sps)):
        sched.submit(GenerateRequest(rid=rid, prompt=p, max_new_tokens=6,
                                     sampling=sp))
    res = _run(sched)
    for rid, (p, sp) in enumerate(zip(prompts, sps)):
        assert res[rid].tokens == lockstep_generate(eng, p, 6, sampling=sp)
    assert lockstep_generate(eng, prompts[0], 6, sampling=sps[0]) \
        == res[0].tokens


def test_sampled_tokens_actually_differ_from_greedy(eng):
    (p,) = _prompts([10], seed=4)
    greedy = lockstep_generate(eng, p, 12)
    draws = {tuple(lockstep_generate(
        eng, p, 12, sampling=SamplingParams(temperature=5.0, seed=s)))
        for s in range(3)}
    assert any(d != tuple(greedy) for d in draws)


def test_stop_sequence_mid_decode(eng):
    (p,) = _prompts([11], seed=10)
    ref = lockstep_generate(eng, p, 10)
    stop = (tuple(ref[2:4]),)                   # hit after the 4th token
    # the written contract needs the pair not to end any earlier prefix
    assert tuple(ref[0:2]) != stop[0] and tuple(ref[1:3]) != stop[0]
    sched = Scheduler(eng, n_slots=1)
    sched.submit(GenerateRequest(rid=0, prompt=p, max_new_tokens=10,
                                 stop=[list(stop[0]), []]))
    res = sched.run_to_completion()[0]
    assert res.finish_reason == "stop"
    assert res.tokens == ref[:4]                # matched suffix stays
    assert lockstep_generate(eng, p, 10, stop=stop) == ref[:4]


def test_stop_sequences_are_canonicalised():
    req = GenerateRequest(rid=0, prompt=np.zeros(3, np.int32),
                          max_new_tokens=2, stop=[[1, 2], (), np.array([3])])
    assert req.stop == ((1, 2), (3,))


def test_cancellation_mid_decode_and_while_queued(eng):
    pa, pb = _prompts([13, 9], seed=8)
    tok_a, tok_b = CancelToken(), CancelToken()
    seen = []

    def cancel_after_three(sr: StepResult):
        seen.append(sr.token)
        if sr.index == 2:
            tok_a.cancel()

    sched = Scheduler(eng, n_slots=1, check_invariants=True)
    sched.submit(GenerateRequest(rid=0, prompt=pa, max_new_tokens=12,
                                 on_token=cancel_after_three, cancel=tok_a))
    sched.submit(GenerateRequest(rid=1, prompt=pb, max_new_tokens=12,
                                 cancel=tok_b))
    tok_b.cancel()                               # cancelled while queued
    res = _run(sched)
    assert res[0].finish_reason == "cancelled"
    assert len(res[0].tokens) == 3 and res[0].tokens == seen
    assert res[1].finish_reason == "cancelled" and res[1].tokens == []
    sched.submit(GenerateRequest(rid=2, prompt=pb, max_new_tokens=4))
    r2 = [r for r in sched.run_to_completion() if r.rid == 2][0]
    assert r2.tokens == lockstep_generate(eng, pb, 4)


def test_lockstep_honors_cancel_and_streams(eng):
    (p,) = _prompts([12], seed=11)
    tok = CancelToken()
    seen = []

    def on_token(sr):
        seen.append(sr)
        if sr.index == 1:
            tok.cancel()

    toks = lockstep_generate(eng, p, 8, on_token=on_token, cancel=tok)
    assert len(toks) == 2 and [s.token for s in seen] == toks
    assert [s.index for s in seen] == [0, 1]


def test_streaming_callback_ordering(eng):
    prompts = _prompts([10, 22], seed=9)
    streams: dict = {0: [], 1: []}

    def on_token(sr: StepResult):
        streams[sr.rid].append(sr)

    sched = Scheduler(eng, n_slots=2)
    for rid, p in enumerate(prompts):
        sched.submit(GenerateRequest(rid=rid, prompt=p, max_new_tokens=5,
                                     on_token=on_token))
    res = _run(sched)
    for rid in range(2):
        srs, r = streams[rid], res[rid]
        assert [sr.index for sr in srs] == list(range(len(r.tokens)))
        assert [sr.token for sr in srs] == r.tokens
        assert [sr.finished for sr in srs] == [False] * (len(srs) - 1) + [True]
        assert srs[-1].finish_reason == r.finish_reason == "length"
        assert len(r.token_times) == len(r.tokens)
        assert all(b >= a for a, b in zip(r.token_times, r.token_times[1:]))
        assert len(r.itl) == len(r.tokens) - 1
        assert r.latency >= r.ttft >= 0


def test_sample_first_uses_the_decode_sampler(eng):
    """A request's first token is step 0 of its key schedule, drawn by the
    same sampler the decode step uses."""
    from repro_torch.serving.sampling import sample_with_seed
    rng = np.random.default_rng(4)
    logits = torch.from_numpy(rng.standard_normal((1, CFG.vocab))
                              .astype(np.float32))
    sp = SamplingParams(temperature=0.8, top_k=20, top_p=0.95, seed=2 ** 31 + 5)
    want = sample_with_seed(logits, torch.tensor([2 ** 31 + 5 - 2 ** 32]),
                            torch.tensor([0]), torch.tensor([0.8]),
                            torch.tensor([20]), torch.tensor([0.95]))
    assert eng.sample_first(logits, sp) == int(want[0])
    assert eng.sample_first(logits) == int(torch.argmax(logits[0]))
