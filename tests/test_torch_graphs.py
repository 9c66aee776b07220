"""The engine's four decode entries as the port captures them, on the CPU
(``bitnet-3b-reduced``, the reference's converted weights):

  * (a) greedy and sampled decode, greedy and sampled retry update the
    pool in place: every pool tensor keeps its storage, no entry is added
    or rebound, and the retry leaves ``active`` as it found it;
  * (b) over several steps, one with a NaN lane injected by a fault plan
    and recovered through rollback and the retry, the port's entries are
    bitwise the reference's compiled ones (``repro.serving.api``): tokens,
    ``ok``, ``lengths``, ``sample_step`` and the int8 K/V/feature leaves;
  * (c) the graph key names a pool exactly, and the key cache stays
    within its bound over many ``lockstep_generate`` calls (key logic
    only: a fake capture stands in for the card's);
  * (d) a CPU engine builds no graph.
"""
from collections import OrderedDict

import jax
import numpy as np
import pytest
import torch

from repro.configs.bitnet_3b import REDUCED as JCFG
from repro.models.transformer import init_params as jinit
from repro.serving import faults as jfaults
from repro.serving.api import PooledEngine as JEngine
from repro.serving.quantize import quantize_params as jquantize
from repro_torch.configs import get_config
from repro_torch.convert import from_numpy_tree
from repro_torch.serving import faults, graphs
from repro_torch.serving.api import PooledEngine, step_inputs
from repro_torch.serving.scheduler import lockstep_generate

torch.set_num_threads(1)

MAX_LEN = 63          # pool capacity 64 with the reduced lop_block of 32
CFG = get_config("bitnet-3b-reduced")
ENTRIES = ("greedy", "sampled", "retry_greedy", "retry_sampled")
SAMPLED = (0.8, 20, 0.9)        # temperature, top-k, top-p of a sampled lane
INT_LEAVES = ("k", "v", "feat")


@pytest.fixture(scope="module")
def weights():
    params, _ = jinit(JCFG, jax.random.PRNGKey(0))
    jqp = jquantize(JCFG, params)
    return jqp, from_numpy_tree(jax.tree.map(np.asarray, jqp), "cpu")


@pytest.fixture(scope="module")
def eng(weights):
    return PooledEngine(CFG, weights[1], max_len=MAX_LEN, device="cpu")


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab, n).astype(np.int32) for n in lens]


def _lane_params(sampled_lanes, n):
    temps = np.zeros(n, np.float32)
    tks = np.zeros(n, np.int32)
    tps = np.ones(n, np.float32)
    for lane in sampled_lanes:
        temps[lane], tks[lane], tps[lane] = SAMPLED
    return temps, tks, tps


def _tensors(tree, prefix=""):
    for name, val in sorted(tree.items()):
        if isinstance(val, dict):
            yield from _tensors(val, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", val


def _port_pool(eng, lens, seed=1):
    """A 3-slot pool with lanes 0 and 2 prefilled and active (lane 1
    free), each lane's key schedule at step 1. → (pool, next tokens)."""
    pool = eng.init_pool(3)
    nxt = np.zeros((3, 1), np.int32)
    for slot, p in zip((0, 2), _prompts(lens, seed)):
        logits, one = eng.prefill(p[None])
        pool = eng.insert(pool, slot, one)
        pool = eng.set_sampling_state(pool, slot, 10 + slot, 1)
        nxt[slot, 0] = int(torch.argmax(logits[0]))
    return pool, nxt


# ---------------------------------------------------------------------------
# (a) in place
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("entry", ENTRIES)
def test_entry_updates_pool_in_place(eng, entry):
    pool, nxt = _port_pool(eng, (20, 29))
    retry = entry.startswith("retry")
    if retry:
        pool = eng.rollback(pool, 2, 1)
    ptrs = {name: t.data_ptr() for name, t in _tensors(pool)}
    before = {name: t.clone() for name, t in _tensors(pool)}
    params = _lane_params((0, 2) if entry.endswith("sampled") else (), 3)
    if retry:
        toks, ok, out = eng.retry_step(pool, 2, nxt, *params)
    else:
        toks, out = eng.decode_step(pool, nxt, *params)
    assert out is pool
    assert {name: t.data_ptr() for name, t in _tensors(pool)} == ptrs
    assert torch.equal(pool["active"], before["active"])
    # the lanes that moved: both active lanes, or only the retried one
    lanes = [2] if retry else [0, 2]
    grown = (pool["lengths"] - before["lengths"]).tolist()
    assert grown == [int(i in lanes) for i in range(3)]
    steps = (pool["sample_step"] - before["sample_step"]).tolist()
    assert steps == [int(i in lanes and entry.endswith("sampled"))
                     for i in range(3)]
    for name in INT_LEAVES:
        changed = (pool["layers"][name] != before[f"layers.{name}"])
        assert changed.flatten(2).any(-1).any(0).tolist() == [
            i in lanes for i in range(3)], name


# ---------------------------------------------------------------------------
# (b) bitwise the reference's compiled entries
# ---------------------------------------------------------------------------

def _ref_pool(jeng, lens, seed=1):
    pool = jeng.init_pool(3)
    nxt = np.zeros((3, 1), np.int32)
    for slot, p in zip((0, 2), _prompts(lens, seed)):
        logits, one = jeng.prefill(p[None], len(p), {})
        pool = jeng.insert(pool, slot, one)
        pool = jeng.set_sampling_state(pool, slot, 10 + slot, 1)
        nxt[slot, 0] = int(np.argmax(np.asarray(logits)[0]))
    return pool, nxt


def _assert_pools_equal(jpool, tpool, where):
    j = jax.tree.map(np.asarray, jpool)
    for name in ("lengths", "sample_step", "active", "seed"):
        assert np.array_equal(tpool[name].numpy(), j[name]), (where, name)
    for name in INT_LEAVES:
        assert np.array_equal(tpool["layers"][name].numpy(),
                              j["layers"][name]), (where, name)


@pytest.mark.parametrize("sampled_lanes", [(), (2,)],
                         ids=["greedy", "sampled"])
def test_entries_bitwise_reference(weights, sampled_lanes):
    jqp, tqp = weights
    jeng = JEngine(JCFG, jqp, max_len=MAX_LEN)
    teng = PooledEngine(CFG, tqp, max_len=MAX_LEN, device="cpu")
    jpool, nxt = _ref_pool(jeng, (20, 29))
    tpool = from_numpy_tree(jax.tree.map(np.asarray, jpool), "cpu")
    params = _lane_params(sampled_lanes, 3)
    nan = frozenset({(2, 0), (4, 2)})
    retries = 0
    with jfaults.inject(jfaults.FaultPlan(nan_logits=nan)), \
            faults.inject(faults.FaultPlan(nan_logits=nan)):
        for step in range(6):
            jt, jpool = jeng.decode_step(jpool, nxt, *params)
            tt, tpool = teng.decode_step(tpool, nxt, *params)
            assert np.array_equal(tt[[0, 2]], np.asarray(jt)[[0, 2]]), step
            assert np.array_equal(teng.last_ok, jeng.last_ok), step
            _assert_pools_equal(jpool, tpool, step)
            for slot in (0, 2):
                if not teng.last_ok[slot]:
                    retries += 1
                    jpool = jeng.rollback(jpool, slot, 1)
                    tpool = teng.rollback(tpool, slot, 1)
                    jt2, jok, jpool = jeng.retry_step(jpool, slot, nxt,
                                                      *params)
                    tt2, tok, tpool = teng.retry_step(tpool, slot, nxt,
                                                      *params)
                    assert tt2[slot] == int(np.asarray(jt2)[slot])
                    assert tok[slot] and bool(np.asarray(jok)[slot])
                    _assert_pools_equal(jpool, tpool, (step, "retry"))
                    tt[slot] = tt2[slot]
            nxt = tt.reshape(3, 1).astype(np.int32)
    assert retries == 2


# ---------------------------------------------------------------------------
# (c) the graph key and the bound
# ---------------------------------------------------------------------------

def test_graph_key_names_the_pool(eng):
    pool, nxt = _port_pool(eng, (9, 12))
    key = graphs.graph_key("greedy", pool)
    assert graphs.graph_key("greedy", pool) == key
    eng.decode_step(pool, nxt, *_lane_params((), 3))
    assert graphs.graph_key("greedy", pool) == key      # stepped in place
    assert graphs.graph_key("sampled", pool) != key
    assert graphs.graph_key("greedy", eng.init_pool(3)) != key
    assert graphs.graph_key("greedy", eng.init_pool(2)) != key
    view = dict(pool, lengths=pool["lengths"][:2])
    assert graphs.graph_key("greedy", view) != key


class _FakeGraphs(graphs.StepGraphs):
    """The key cache with the card's warm-up, capture and replay replaced
    by the eager step, counting each."""

    def __init__(self):
        self.device = torch.device("cpu")
        self._live = OrderedDict()
        self.calls = {"warm": 0, "capture": 0, "replay": 0}
        self.most = 0

    def _eager(self, step, entry, pool, host):
        self.most = max(self.most, len(self._live))
        return step(pool, torch.from_numpy(host), entry)

    def _warm(self, step, entry, pool, host):
        self.calls["warm"] += 1
        return self._eager(step, entry, pool, host)

    def _capture(self, step, entry, pool, host):
        self.calls["capture"] += 1
        self.most = max(self.most, len(self._live))
        return (step, entry, pool)

    def _replay(self, graph, host):
        self.calls["replay"] += 1
        step, entry, pool = graph
        return self._eager(step, entry, pool, host)


def test_graph_cache_stays_within_bound(weights):
    eng = PooledEngine(CFG, weights[1], max_len=MAX_LEN, device="cpu")
    want = [lockstep_generate(eng, p, 4) for p in _prompts([7] * 12, 5)]
    fake = eng.graphs = _FakeGraphs()
    kept = []                      # keep every cache alive: fresh addresses
    prefill = eng.prefill

    def keep(tokens):
        logits, cache = prefill(tokens)
        kept.append(cache)
        return logits, cache

    eng.prefill = keep
    got = [lockstep_generate(eng, p, 4) for p in _prompts([7] * 12, 5)]
    assert got == want
    assert len({graphs.graph_key("greedy", c) for c in kept}) == 12
    # 3 decode steps a request: warm, capture + replay, replay
    assert fake.calls == {"warm": 12, "capture": 12, "replay": 24}
    assert fake.most <= graphs.GRAPH_BOUND
    assert len(fake) == graphs.GRAPH_BOUND


# ---------------------------------------------------------------------------
# (d) no graph on the CPU; the packed inputs
# ---------------------------------------------------------------------------

def test_cpu_engine_builds_no_graph(weights):
    eng = PooledEngine(CFG, weights[1], max_len=MAX_LEN, device="cpu",
                       graphs=True)
    assert eng.graphs is None
    assert lockstep_generate(eng, _prompts([9])[0], 3)
    assert eng.graphs is None


def test_step_inputs_layout():
    host = step_inputs([[3], [4]], None, [0.5, 0.0], [7, 0], 0.25, slot=1)
    assert host.dtype == np.int32 and host.shape == (6, 2)
    assert host[0].tolist() == [3, 4]
    assert host[1].view(np.float32).tolist() == [0.0, 0.0]
    assert host[2].view(np.float32).tolist() == [0.5, 0.0]
    assert host[3].tolist() == [7, 0]
    assert host[4].view(np.float32).tolist() == [0.25, 0.25]
    assert host[5].tolist() == [1, 1]
    nan = step_inputs([[3], [4]], np.array([np.nan, 0], np.float32), 0, 0, 1)
    assert np.isnan(nan[1].view(np.float32)).tolist() == [True, False]
