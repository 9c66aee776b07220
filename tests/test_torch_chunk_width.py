"""The prefill chunk width (``PooledEngine(chunk_tokens=...)``) held
against the reference's ``Scheduler`` on ``bitnet-3b-reduced``
(``lop_block`` 32), token for token, at widths below and above the LOP
block: 8, 16 and 64.

The prompts are ``tests/test_prefill_attention.py``'s chunk-boundary
lengths (9, 16, 17, 32, 33, 45) and two that share a 32-token prefix: the
second hits the interned prefix, resumes at the block boundary and
chunks at the width from there. The deadline that fires between two
prefill chunks at width 8 is ``tests/test_faults.py``'s case, run on both
sides. The CLI's ``--chunk-tokens`` and ``--arrival-period`` run once.

Against the reference the engines decode dense (``use_lop=False``), as
``tests/test_torch_prefix_cache.py`` does: the 45-token prompt's LOP
decode parts from the reference's at its 4th token at every width, the
default one included, and in both sides' lockstep runs too. Its prefill
caches part at the known knife-edge (layer 0's scales apart by ulps,
int8 flips from layer 1), and LOP's one kept block of the two live ones
turns with them; the dense decode's top-2 logit gap there is 0.23 on
both sides. The LOP engine is held to the port's own lockstep stream at
every width instead: the chunk width changes no token.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.bitnet_3b import REDUCED as JCFG
from repro.models.transformer import init_params as jinit
from repro.serving.api import PooledEngine as JEngine
from repro.serving.quantize import quantize_params as jquantize
from repro.serving.scheduler import Request as JRequest
from repro.serving.scheduler import Scheduler as JScheduler
from repro_torch.configs import get_config
from repro_torch.convert import from_numpy_tree
from repro_torch.launch import serve as tserve
from repro_torch.serving.api import GenerateRequest, PooledEngine
from repro_torch.serving.scheduler import Scheduler, lockstep_generate

torch.set_num_threads(1)

CFG = get_config("bitnet-3b-reduced")
MAX_LEN = 127                       # capacity 128: four 32-token blocks
LENS = [9, 16, 17, 32, 33, 45]
GEN = 5


@pytest.fixture(scope="module")
def weights():
    params, _ = jinit(JCFG, jax.random.PRNGKey(0))
    jqp = jquantize(JCFG, params)
    return jqp, from_numpy_tree(jax.tree.map(np.asarray, jqp), "cpu")


def _prompts():
    rng = np.random.default_rng(4)
    shared = rng.integers(0, CFG.vocab, (32,)).astype(np.int32)
    plain = [rng.integers(0, CFG.vocab, (n,)).astype(np.int32)
             for n in LENS]
    sharers = [np.concatenate([shared, rng.integers(
        0, CFG.vocab, (n,)).astype(np.int32)]) for n in (9, 20)]
    # the second sharer comes last: the first one's prefix is interned
    return [sharers[0]] + plain + [sharers[1]]


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_chunk_width_matches_reference_scheduler(weights, chunk):
    jqp, qp = weights
    eng = PooledEngine(CFG, qp, max_len=MAX_LEN, use_lop=False,
                       device="cpu", chunk_tokens=chunk)
    assert eng.chunk_tokens == chunk and eng.prefix_block == CFG.lop_block
    sched = Scheduler(eng, n_slots=2, check_invariants=True)
    jsched = JScheduler(JCFG, jqp, n_slots=2, max_len=MAX_LEN,
                        use_lop=False, chunk_tokens=chunk)
    assert sched.chunk_tokens == jsched.chunk_tokens == chunk
    prompts = _prompts()
    for rid, p in enumerate(prompts):
        sched.submit(GenerateRequest(rid=rid, prompt=p, max_new_tokens=GEN))
        jsched.submit(JRequest(rid=rid, prompt=p, max_new_tokens=GEN))
    res = {r.rid: r for r in sched.run_to_completion()}
    jres = {r.rid: r for r in jsched.run_to_completion()}
    for name in ("prefix_hits", "prefix_hit_tokens",
                 "prefill_tokens_computed", "prefill_tokens_served"):
        assert getattr(sched, name) == getattr(jsched, name), name
    last = len(prompts) - 1
    # the hit resumes at the block boundary, not at a chunk multiple
    assert res[last].cached_len == jres[last].cached_len == CFG.lop_block
    for rid in range(len(prompts)):
        assert res[rid].tokens == [int(t) for t in jres[rid].tokens], rid


@pytest.mark.parametrize("chunk", [8, 64])
def test_lop_chunk_width_keeps_lockstep_tokens(weights, chunk):
    """The LOP engine at a chunk width off the block: every stream, the
    prefix hit's too, equals the port's whole-prompt lockstep stream."""
    _, qp = weights
    eng = PooledEngine(CFG, qp, max_len=MAX_LEN, device="cpu",
                       chunk_tokens=chunk)
    sched = Scheduler(eng, n_slots=2)
    prompts = _prompts()
    for rid, p in enumerate(prompts):
        sched.submit(GenerateRequest(rid=rid, prompt=p, max_new_tokens=GEN))
    res = {r.rid: r for r in sched.run_to_completion()}
    assert sched.prefix_hits == 1
    for rid, p in enumerate(prompts):
        assert res[rid].tokens == lockstep_generate(eng, p, GEN), rid


def test_chunk_plan_resumes_a_hit_at_the_block(weights):
    """A 32-token hit on a 52-token prompt at width 8: chunks at 32, 40
    and 48 (the last padded to the width), as the reference plans it."""
    jqp, qp = weights
    sched = Scheduler(PooledEngine(CFG, qp, max_len=MAX_LEN, device="cpu",
                                   chunk_tokens=8), n_slots=1)
    jsched = JScheduler(JCFG, jqp, n_slots=1, max_len=MAX_LEN,
                        engine=JEngine(JCFG, jqp, max_len=MAX_LEN,
                                       chunk_tokens=8))
    req = GenerateRequest(rid=0, prompt=np.arange(52, dtype=np.int32),
                          max_new_tokens=1)
    plan = sched._plan_chunks(req, skip=32)
    jplan = jsched._plan_chunks(JRequest(rid=0, prompt=req.prompt,
                                         max_new_tokens=1), skip=32)
    assert plan[1] == [32, 40, 48] == list(jplan[1])
    assert plan[2] == list(jplan[2])
    for a, b in zip(plan[0], jplan[0]):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_deadline_between_prefill_chunks_matches_reference(weights):
    """A 40-token prompt at width 8 needs 5 chunk cycles; a 25 ms budget
    at 10 ms a cycle dies mid-prefill and frees the reserved lane, on
    both sides."""
    jqp, qp = weights
    rng = np.random.default_rng(21)
    prompt = rng.integers(0, CFG.vocab, (40,)).astype(np.int32)
    out = {}
    for side in ("port", "reference"):
        t = [0.0]
        if side == "port":
            sched = Scheduler(PooledEngine(CFG, qp, max_len=MAX_LEN,
                                           use_lop=False, device="cpu",
                                           chunk_tokens=8),
                              n_slots=1, clock=lambda: t[0])
            req = GenerateRequest(rid=0, prompt=prompt, max_new_tokens=4,
                                  deadline_ms=25.0)
        else:
            sched = JScheduler(JCFG, jqp, n_slots=1, max_len=MAX_LEN,
                               engine=JEngine(JCFG, jqp, max_len=MAX_LEN,
                                              use_lop=False, chunk_tokens=8),
                               clock=lambda: t[0])
            req = JRequest(rid=0, prompt=prompt, max_new_tokens=4,
                           deadline_ms=25.0)
        sched.submit(req)
        steps = 0
        while sched.has_work():
            sched.admit()
            sched.step()
            t[0] += 0.01
            steps += 1
            assert steps < 50, "deadline never fired"
        res = sched.results[0]
        assert res.finish_reason == "deadline" and list(res.tokens) == []
        assert sched.n_prefilling == 0 and len(sched._free) == 1
        assert sched.deadline_count == 1
        out[side] = steps
    assert out["port"] == out["reference"] < 6


def test_serve_cli_chunk_width_and_arrivals(capsys):
    """``--chunk-tokens 8 --arrival-period 0.01``: staggered arrivals,
    chunk width in the stats, scheduler == lockstep."""
    assert tserve.main(["--reduced", "--device", "cpu", "--requests", "3",
                        "--min-prompt", "9", "--max-prompt", "20",
                        "--gen", "3", "--chunk-tokens", "8",
                        "--arrival-period", "0.01", "--verify"]) == 0
    out = capsys.readouterr().out
    assert "chunk 8 tokens, arrivals every 0.01 s" in out
    assert "token equivalence: OK" in out


def test_serve_cli_no_chunked(capsys, monkeypatch):
    """``--no-chunked``: every prompt prefilled whole at its exact length,
    run to completion (the reference CLI's flag); ``chunked`` false in the
    stats, scheduler == lockstep."""
    stats = {}
    serve_loop = tserve.serve_loop

    def keep(*args, **kw):
        stats.update(serve_loop(*args, **kw))
        return stats
    monkeypatch.setattr(tserve, "serve_loop", keep)
    assert tserve.main(["--reduced", "--device", "cpu", "--requests", "3",
                        "--min-prompt", "9", "--max-prompt", "40",
                        "--gen", "3", "--no-chunked", "--verify"]) == 0
    out = capsys.readouterr().out
    assert stats["chunked"] is False and stats["full_prefills"] == 3
    assert stats["prefix_cache"] is False
    assert "run-to-completion prefill, arrivals" in out
    assert "full-prompt prefills (exact length, run to completion): 3" in out
    assert "token equivalence: OK" in out
