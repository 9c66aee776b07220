"""The port's serving path on ``bitnet-3b-reduced``, held against the JAX
reference on the same (converted) weights, on the CPU.

  * greedy ``lockstep_generate`` tokens equal the reference's, LOP on and
    off;
  * the port's chunked prefill is bitwise its whole-prompt prefill;
  * the port's Scheduler gives token for token the port's lockstep.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.bitnet_3b import REDUCED as JCFG
from repro.models.transformer import init_params as jinit
from repro.serving.quantize import quantize_params as jquantize
from repro.serving.scheduler import lockstep_generate as jlockstep
from repro_torch.configs import get_config
from repro_torch.convert import from_numpy_tree
from repro_torch.serving.api import GenerateRequest, PooledEngine
from repro_torch.serving.scheduler import Scheduler, lockstep_generate

torch.set_num_threads(1)

MAX_LEN = 63          # pool capacity 64 with the reduced lop_block of 32
CFG = get_config("bitnet-3b-reduced")


@pytest.fixture(scope="module")
def weights():
    params, _ = jinit(JCFG, jax.random.PRNGKey(0))
    jqp = jquantize(JCFG, params)
    return jqp, from_numpy_tree(jax.tree.map(np.asarray, jqp), "cpu")


def _prompts(n, lo=5, hi=40, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab, int(rng.integers(lo, hi + 1)))
            .astype(np.int32) for _ in range(n)]


@pytest.mark.parametrize("use_lop", [True, False])
def test_lockstep_tokens_match_reference(weights, use_lop):
    jqp, tqp = weights
    eng = PooledEngine(CFG, tqp, max_len=MAX_LEN, use_lop=use_lop,
                       device="cpu")
    for p in _prompts(3, lo=20, hi=45, seed=1):
        want = jlockstep(JCFG, jqp, p, 12, max_len=MAX_LEN, use_lop=use_lop)
        got = lockstep_generate(eng, p, 12)
        assert got == want


def test_chunked_prefill_bitwise_whole(weights):
    _, tqp = weights
    eng = PooledEngine(CFG, tqp, max_len=MAX_LEN, device="cpu")
    prompt = _prompts(1, lo=45, hi=45, seed=2)[0]
    whole_logits, whole = eng.prefill(prompt[None])
    sched = Scheduler(eng, n_slots=2)
    sched.submit(GenerateRequest(rid=0, prompt=prompt, max_new_tokens=1))
    sched.admit()
    pf = sched._prefilling[0]
    for k in range(len(pf.chunks)):
        logits, pool = eng.prefill_chunk(sched.pool, pf.slot, pf.chunks[k],
                                         pf.starts[k], pf.seq_ends[k],
                                         k == len(pf.chunks) - 1)
    assert len(pf.chunks) == 2
    assert torch.equal(logits, whole_logits)
    s = len(prompt)
    for key, leaf in whole["layers"].items():
        lane = pool["layers"][key][:, pf.slot]
        assert torch.equal(lane[:, :, :s], leaf[:, 0, :, :s]), key
    assert int(pool["lengths"][pf.slot]) == s and bool(pool["active"][pf.slot])


def test_scheduler_matches_lockstep(weights):
    _, tqp = weights
    eng = PooledEngine(CFG, tqp, max_len=MAX_LEN, device="cpu")
    prompts = _prompts(6, lo=5, hi=50, seed=3)
    sched = Scheduler(eng, n_slots=3)
    for rid, p in enumerate(prompts):
        sched.submit(GenerateRequest(rid=rid, prompt=p,
                                     max_new_tokens=13 - rid))
    results = {r.rid: r for r in sched.run_to_completion()}
    assert sorted(results) == list(range(6))
    for rid, p in enumerate(prompts):
        ref = lockstep_generate(eng, p, 13 - rid)
        assert results[rid].tokens == ref, rid
        assert results[rid].finish_reason == "length"


def test_eos_retires_lane(weights):
    _, tqp = weights
    eng = PooledEngine(CFG, tqp, max_len=MAX_LEN, device="cpu")
    p = _prompts(1, seed=4)[0]
    ref = lockstep_generate(eng, p, 8)
    sched = Scheduler(eng, n_slots=1)
    sched.submit(GenerateRequest(rid=0, prompt=p, max_new_tokens=8,
                                 eos_id=ref[2]))
    (res,) = sched.run_to_completion()
    assert res.tokens == ref[:ref.index(ref[2]) + 1]
    assert res.finish_reason == "eos"


def test_quantize_params_bitwise_reference():
    """The port's quantize_params on the reference's master weights gives
    the reference's serving tree: codes, norms, embed and head bitwise, γ
    (a mean, whose last bits follow the summation order) at rtol 1e-6. The
    port's seeded init_params has the reference's master tree structure,
    shapes and dtypes."""
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.quantize import quantize_params
    params, _ = jinit(JCFG, jax.random.PRNGKey(3))
    want = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jquantize(JCFG, params)))[0]
    got = dict(jax.tree_util.tree_flatten_with_path(quantize_params(
        CFG, from_numpy_tree(jax.tree.map(np.asarray, params), "cpu")))[0])
    assert set(got) == {path for path, _ in want}
    for path, leaf in want:
        if "scale" in jax.tree_util.keystr(path):
            np.testing.assert_allclose(got[path].numpy(), leaf, rtol=1e-6,
                                       atol=0, err_msg=str(path))
        else:
            assert np.array_equal(got[path].numpy(), leaf), path
    ours = dict(jax.tree_util.tree_flatten_with_path(
        init_params(CFG, 7, "cpu"))[0])
    ref = jax.tree_util.tree_flatten_with_path(params)[0]
    assert set(ours) == {path for path, _ in ref}
    for path, leaf in ref:
        assert ours[path].shape == leaf.shape, path
        assert str(ours[path].dtype).split(".")[-1] == str(leaf.dtype), path


def test_serve_cli_verifies_on_cpu(capsys):
    from repro_torch.launch.serve import main
    rc = main(["--arch", "bitnet-3b", "--reduced", "--slots", "2",
               "--requests", "3", "--min-prompt", "6", "--max-prompt", "40",
               "--gen", "5", "--device", "cpu", "--verify"])
    out = capsys.readouterr().out
    assert rc == 0 and "token equivalence: OK" in out, out


def test_serve_cli_prefix_and_spec_on_cpu(capsys):
    """The serve CLI with a shared prefix and speculative decoding: hits
    and rounds happen, and every stream equals its lockstep replay."""
    import re

    from repro_torch.launch.serve import main
    rc = main(["--reduced", "--slots", "2", "--requests", "4",
               "--max-prompt", "24", "--gen", "6", "--device", "cpu",
               "--no-lop", "--spec-decode", "--shared-prefix-tokens", "64",
               "--verify"])
    out = capsys.readouterr().out
    assert rc == 0 and "token equivalence: OK" in out, out
    assert int(re.search(r"prefix cache: (\d+) hits", out).group(1)) > 0
    assert int(re.search(r"speculative decode: (\d+) rounds",
                         out).group(1)) > 0


def test_pool_insert_extract_evict(weights):
    _, tqp = weights
    eng = PooledEngine(CFG, tqp, max_len=MAX_LEN, device="cpu")
    prompt = _prompts(1, lo=30, hi=30, seed=5)[0]
    _, one = eng.prefill(prompt[None])
    pool = eng.insert(eng.init_pool(3), 1, one)
    lane = eng.extract(pool, 1)
    for key, leaf in one["layers"].items():
        assert torch.equal(lane["layers"][key], leaf), key
    assert pool["active"].tolist() == [False, True, False]
    assert pool["lengths"].tolist() == [0, 30, 0]
    pool = eng.evict(pool, 1)
    assert not pool["active"].any() and not pool["lengths"].any()
    assert not pool["layers"]["feat"][:, 1].any()
    # extract copies: the eviction did not reach the extracted lane
    assert torch.equal(lane["layers"]["feat"], one["layers"]["feat"])
    assert torch.equal(pool["layers"]["k"][:, 1], one["layers"]["k"][:, 0])
