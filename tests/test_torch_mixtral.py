"""The port's moe family with a sliding window on
``mixtral-8x22b-reduced`` (4 layers, d 128, 4 experts top-2,
``swa_window`` 64, ``moe_group`` 64, ``lop_block`` 32) held against the
JAX reference on the CPU, with prompts that straddle the window (40, 90
and 130 tokens, 12 new, ``max_len`` 159: capacity 160):

  * greedy tokens: the port's Scheduler (run-to-completion, exact-length
    prefill, 2 slots) equals the reference's ``lockstep_generate`` and
    the port's, with LOP and without;
  * one whole prefill of the 130-token prompt, whose last rows attend
    past the window: its logits within rtol = atol = 2e-5 of the
    reference's.

The engines are built once a module and shared across cases."""
import jax
import numpy as np
import pytest
import torch

from repro.configs.mixtral_8x22b import REDUCED as JCFG
from repro.models.transformer import init_params as jinit
from repro.serving import engine as jeng
from repro.serving.quantize import quantize_params as jquantize
from repro.serving.scheduler import lockstep_generate as jlockstep
from repro_torch.configs import get_config
from repro_torch.convert import from_numpy_tree
from repro_torch.serving import engine as teng
from repro_torch.serving.api import GenerateRequest, PooledEngine
from repro_torch.serving.scheduler import Scheduler, lockstep_generate

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)
CFG = get_config("mixtral-8x22b-reduced")
LENS, GEN = (40, 90, 130), 12
MAX_LEN = max(LENS) + GEN + 17          # 159: capacity 160 (5 blocks)


@pytest.fixture(scope="module")
def weights():
    params, _ = jinit(JCFG, jax.random.PRNGKey(0))
    jqp = jquantize(JCFG, params)
    return jqp, from_numpy_tree(jax.tree.map(np.asarray, jqp), "cpu")


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(0, CFG.vocab, (n,)).astype(np.int32) for n in LENS]


@pytest.fixture(scope="module")
def engines(weights):
    _, tqp = weights
    return {lop: PooledEngine(CFG, tqp, max_len=MAX_LEN, use_lop=lop,
                              device="cpu") for lop in (True, False)}


def test_config_straddles_the_window():
    assert CFG.family == "moe" and CFG.swa_window == 64
    assert (CFG.n_experts, CFG.top_k) == (4, 2)
    assert min(LENS) < CFG.swa_window < max(LENS)
    assert max(LENS) + GEN > 2 * CFG.swa_window


@pytest.mark.parametrize("use_lop", [True, False], ids=["lop", "no-lop"])
def test_scheduler_past_the_window_matches_reference_lockstep(
        weights, prompts, engines, use_lop):
    """Every stream equals the reference's lockstep and the port's; the
    prompts are prefilled whole at their exact lengths."""
    jqp, _ = weights
    eng = engines[use_lop]
    sched = Scheduler(eng, n_slots=2, check_invariants=True)
    assert not sched.chunked and sched.capacity == MAX_LEN + 1
    for rid, p in enumerate(prompts):
        sched.submit(GenerateRequest(rid=rid, prompt=p, max_new_tokens=GEN))
    got = {r.rid: r.tokens for r in sched.run_to_completion()}
    assert sched.prefill_tokens_computed == sum(LENS)
    for rid, p in enumerate(prompts):
        want = jlockstep(JCFG, jqp, p, GEN, max_len=MAX_LEN, use_lop=use_lop)
        assert len(want) == GEN
        assert got[rid] == want, rid
        assert lockstep_generate(eng, p, GEN) == want, rid


def test_prefill_logits_past_the_window(weights, prompts):
    """The 130-token prompt's whole prefill: its last row attends to the
    window's 64 keys only; the logits within 2e-5 of the reference's."""
    jqp, tqp = weights
    p = prompts[-1]
    want, _ = jeng.prefill(JCFG, jqp, p[None], max_len=MAX_LEN)
    got, _ = teng.prefill(CFG, tqp, torch.from_numpy(p[None]),
                          max_len=MAX_LEN)
    want = torch.from_numpy(np.array(want))
    assert got.shape == want.shape == (1, CFG.vocab_padded)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **TOL)
