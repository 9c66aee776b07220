"""The port's observability core (``repro_torch.serving.metrics``) held to
the reference's (``repro.serving.metrics``), case for case of
``tests/test_metrics.py``, on the CPU:

  * the same registry operations on both give the same ``render()`` text
    byte for byte, and the same values, merges and quantile estimates;
  * ``percentile`` / ``summarize`` give the same floats as the
    reference's (numpy's linear interpolation);
  * ``StageTimer`` spans are the reference's on the same clock;
  * a scheduler run on ``bitnet-3b-reduced`` (the reference's weights,
    converted) under a virtual clock publishes the reference scheduler's
    series, text for text: a plain run, one under shedding, a deadline, a
    cancellation and a recovered NaN fault, one with prefix hits and one
    speculative run.
"""
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs.bitnet_3b import REDUCED as JCFG
from repro.models.transformer import init_params as jinit
from repro.serving import faults as jfaults
from repro.serving import metrics as jmetrics
from repro.serving.api import CancelToken as JCancel
from repro.serving.api import GenerateRequest as JRequest
from repro.serving.quantize import quantize_params as jquantize
from repro.serving.scheduler import Scheduler as JScheduler
from repro_torch.configs import get_config
from repro_torch.convert import from_numpy_tree
from repro_torch.serving import faults
from repro_torch.serving import metrics
from repro_torch.serving.api import CancelToken, GenerateRequest, PooledEngine
from repro_torch.serving.scheduler import Scheduler

torch.set_num_threads(1)

MAX_LEN = 63          # pool capacity 64 with the reduced lop_block of 32
CFG = get_config("bitnet-3b-reduced")
SIDES = (jmetrics, metrics)


def _both(ops):
    """Run ``ops(module, registry)`` on a fresh registry of each side. →
    the two registries (reference first)."""
    regs = []
    for mod in SIDES:
        reg = mod.MetricsRegistry()
        ops(mod, reg)
        regs.append(reg)
    return regs


def _same_text(ops):
    ref, got = _both(ops)
    assert got.render() == ref.render()
    return ref, got


# ---------------------------------------------------------------------------
# percentile / summarize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q", [0, 25, 50, 90, 99, 100])
def test_percentile_matches_reference_and_numpy(q):
    xs = np.random.default_rng(0).standard_normal(37).tolist()
    got = metrics.percentile(xs, q)
    assert got == jmetrics.percentile(xs, q) == float(np.percentile(xs, q))


def test_percentile_empty_and_nan_like_reference():
    assert math.isnan(metrics.percentile([], 50))
    assert math.isnan(metrics.percentile([1.0, float("nan")], 50))
    assert math.isnan(jmetrics.percentile([1.0, float("nan")], 50))


def test_summarize_keys_and_values_match_reference():
    vals = np.random.default_rng(1).uniform(0, 2, 23).tolist()
    got = metrics.summarize(vals, (50, 90, 99), prefix="ttft_")
    assert got == jmetrics.summarize(vals, (50, 90, 99), prefix="ttft_")
    assert set(got) == {"ttft_p50", "ttft_p90", "ttft_p99"}
    assert metrics.summarize([1.0, 2.0, 3.0], (50, 99),
                             prefix="x_")["x_p50"] == 2.0


# ---------------------------------------------------------------------------
# the registry: the same operations, the same text
# ---------------------------------------------------------------------------

def _roundtrip(mod, reg):
    c = reg.counter("t_total", "help", ("k",))
    c.labels(k="a").inc()
    c.labels(k="a").inc(2)
    c.labels(k="b").inc()
    g = reg.gauge("t_depth", "help")
    g.set(7)
    g.dec(3)
    h = reg.histogram("t_seconds", "help", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)


def _cumulative(mod, reg):
    h = reg.histogram("lat_seconds", "h", buckets=(0.1, 1.0))
    for v in (0.05, 0.05, 0.5, 5.0):
        h.observe(v)


def _shape(mod, reg):
    reg.counter("a_total", "things done", ("mode",)).labels(
        mode="fast").inc()
    reg.gauge("b_now", "current").set(2.5)
    # label values that need escaping, a float sum, the default buckets
    reg.counter("c_total", "quoted", ("path",)).labels(
        path='a"b\\c\nd').inc(0.25)
    h = reg.histogram("d_seconds", "default buckets", ("stage",))
    for v in (1e-4, 0.003, 0.07, 0.7, 12.0, 99.0):
        h.labels(stage="x").observe(v)
    reg.gauge("e_big", "large").set(3e17)


def _instruments(mod, reg):
    m = mod.scheduler_instruments(reg)
    m.requests.labels(outcome="length").inc()
    m.prefill_tokens.labels(source="cached").inc(64)
    m.ttft.observe(0.123)
    m.queue_depth.set(3)
    h = mod.http_instruments(reg)
    h.requests.labels(route="/v1/completions", code=200).inc()
    h.in_flight.inc()
    h.in_flight.dec()


@pytest.mark.parametrize("ops", [_roundtrip, _cumulative, _shape,
                                 _instruments],
                         ids=["roundtrip", "cumulative", "shape",
                              "instruments"])
def test_render_bytewise_reference(ops):
    _same_text(ops)


def test_values_match_reference():
    ref, got = _same_text(_roundtrip)
    for name, labels in (("t_total", {"k": "a"}), ("t_total", {"k": "b"}),
                         ("t_depth", None), ("t_seconds", None),
                         ("never_total", None)):
        assert got.value(name, labels) == ref.value(name, labels)
    assert got.value("t_total", {"k": "a"}) == 3
    assert got.value("t_depth") == 4
    assert got.value("t_seconds") == pytest.approx(5.55)     # _sum


def test_histogram_text_cumulative():
    _, got = _same_text(_cumulative)
    text = got.render()
    assert 'lat_seconds_bucket{le="0.1"} 2' in text
    assert 'lat_seconds_bucket{le="1"} 3' in text
    assert 'lat_seconds_bucket{le="+Inf"} 4' in text
    assert "lat_seconds_count 4" in text
    names = [line.split()[2] for line in _same_text(_shape)[1]
             .render().splitlines() if line.startswith("# TYPE")]
    assert names == sorted(names)


def test_reregistration_is_idempotent_but_kind_checked():
    for mod in SIDES:
        reg = mod.MetricsRegistry()
        a = reg.counter("x_total", "help")
        assert reg.counter("x_total", "other help") is a
        with pytest.raises(AssertionError):
            reg.gauge("x_total", "now a gauge")
        with pytest.raises(AssertionError):
            reg.counter("bad name", "help")
        with pytest.raises(AssertionError):
            a.inc(-1)


def test_merge_matches_reference():
    def merged(mod, reg):
        other = mod.MetricsRegistry()
        for r, n in ((reg, 2), (other, 3)):
            r.counter("m_total", "h", ("k",)).labels(k="x").inc(n)
            r.histogram("m_seconds", "h", buckets=(1.0,)).observe(0.5 * n)
            r.gauge("m_depth", "h").set(n)
        other.counter("m_only_total", "h").inc(4)
        reg.merge(other)

    ref, got = _same_text(merged)
    assert got.value("m_total", {"k": "x"}) == 5
    assert "m_seconds_count 2" in got.render()
    assert got.value("m_depth") == 3          # gauges take the newer value


def test_histogram_quantile_matches_reference():
    xs = np.random.default_rng(1).uniform(0.02, 0.9, 500)

    def fill(mod, reg):
        h = reg.histogram("q_seconds", "h", buckets=(0.01, 0.1, 1.0, 10.0))
        for v in xs:
            h.observe(float(v))

    ref, got = _same_text(fill)
    for q in (0.0, 0.25, 0.5, 0.99, 1.0):
        est = got._families["q_seconds"].labels().quantile(q)
        assert est == ref._families["q_seconds"].labels().quantile(q)
    assert 0.01 <= got._families["q_seconds"].labels().quantile(0.5) <= 1.0


# ---------------------------------------------------------------------------
# StageTimer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stages,want", [
    (("queue", "prefill", "decode"),
     {"queue": 1.0, "prefill": 2.0, "decode": 3.0}),
    (("decode", "prefill", "decode"), {"decode": 4.0, "prefill": 1.0})],
    ids=["spans", "reentry"])
def test_stage_timer_matches_reference(stages, want):
    spans = []
    for mod in SIDES:
        ticks = iter([0.0, 1.0, 1.0, 3.0, 3.0, 6.0] if want.get("queue")
                     else [0.0, 1.0, 1.0, 2.0, 2.0, 5.0])
        t = mod.StageTimer(clock=lambda: next(ticks))
        t.enter(stages[0])
        for s in stages[1:]:
            t.to(s)
        spans.append(t.finish())
    assert spans[0] == spans[1] == want


def test_default_registry_is_process_wide():
    assert isinstance(metrics.REGISTRY, metrics.MetricsRegistry)
    assert metrics.REGISTRY is not jmetrics.REGISTRY
    c = metrics.REGISTRY.counter("test_selfcheck_total", "scratch")
    before = metrics.REGISTRY.value("test_selfcheck_total")
    c.inc()
    assert metrics.REGISTRY.value("test_selfcheck_total") == before + 1


# ---------------------------------------------------------------------------
# the scheduler's series against the reference scheduler's, virtual clock
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    params, _ = jinit(JCFG, jax.random.PRNGKey(0))
    jqp = jquantize(JCFG, params)
    return jqp, from_numpy_tree(jax.tree.map(np.asarray, jqp), "cpu")


@pytest.fixture(scope="module")
def engines(weights):
    """The port's LOP and no-LOP engines on the converted weights."""
    return {lop: PooledEngine(CFG, weights[1], max_len=MAX_LEN, use_lop=lop,
                              device="cpu") for lop in (True, False)}


def _prompts(lens, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab, (n,)).astype(np.int32) for n in lens]


# scenario → (prompt lengths, max_new_tokens, scheduler kwargs, use_lop,
#             NaN decode calls, deadline rids, cancel rid, shared prefix)
SCENARIOS = {
    # tests/test_metrics.py's served fixture
    "plain": ((9, 14, 11), 5, dict(n_slots=2), True, (), (), None, 0),
    # shed past a bound of 3, a deadline that expires mid-decode, a
    # cancellation after 2 tokens, a recovered NaN on lane 0
    "robust": ((9, 14, 11, 7, 12), 6, dict(n_slots=2, max_queue=3), False,
               ((2, 0),), (1,), 0, 0),
    # a shared 32-token prefix: cached prefill tokens
    "prefix": ((5, 9, 7), 4, dict(n_slots=1), True, (), (), None, 32),
    # speculative rounds: the draft and verify spans
    "spec": ((9, 21), 12, dict(n_slots=2, spec_decode=True, gamma=4), False,
             (), (), None, 0),
}


# streams that part from the reference's at a prefill near-tie (see
# test_prefix_parting_is_a_prefill_near_tie)
PARTED = {("prefix", 2)}


def _scenario_requests(name, side):
    lens, gen, _, _, _, deadlines, cancel_rid, shared = SCENARIOS[name]
    req_cls, tok_cls = (JRequest, JCancel) if side == "ref" else \
        (GenerateRequest, CancelToken)
    prefix = _prompts((shared,), seed=11)[0] if shared else None
    reqs, tokens = [], {}
    for rid, p in enumerate(_prompts(lens)):
        if prefix is not None:
            p = np.concatenate([prefix, p])
        tok = tok_cls() if rid == cancel_rid else None
        if tok is not None:
            tokens[rid] = tok
        reqs.append(req_cls(rid=rid, prompt=p, max_new_tokens=gen,
                            deadline_ms=35.0 if rid in deadlines else None,
                            cancel=tok))
    return reqs, tokens


def _serve(name, sched, reqs, tokens, t):
    """Submit ``reqs`` at t = 0, then admit/step with the virtual clock
    moved 10 ms a cycle; a cancel fires once its lane holds 2 tokens."""
    for r in reqs:
        sched.submit(r)
    steps = 0
    while sched.has_work():
        sched.admit()
        sched.step()
        t[0] += 0.01
        for rid, tok in tokens.items():
            lane = next((ln for ln in sched.lanes
                         if ln is not None and ln.req.rid == rid), None)
            if lane is not None and len(lane.tokens) >= 2:
                tok.cancel()
        steps += 1
        assert steps < 500, name
    return {r.rid: r for r in sched.results}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scheduler_series_match_reference(weights, engines, name):
    jqp, _ = weights
    _, _, kw, lop, nan, _, _, _ = SCENARIOS[name]
    out = {}
    for side in ("ref", "port"):
        reg = (jmetrics if side == "ref" else metrics).MetricsRegistry()
        t = [0.0]
        if side == "ref":
            sched = JScheduler(JCFG, jqp, max_len=MAX_LEN, use_lop=lop,
                               clock=lambda: t[0], metrics=reg, **kw)
            plan = jfaults.FaultPlan(nan_logits=frozenset(nan))
            ctx = jfaults.inject(plan)
        else:
            sched = Scheduler(engines[lop], clock=lambda: t[0], metrics=reg,
                              check_invariants=True, **kw)
            ctx = faults.inject(faults.FaultPlan(nan_logits=frozenset(nan)))
        reqs, tokens = _scenario_requests(name, side)
        with ctx:
            res = _serve(name, sched, reqs, tokens, t)
        out[side] = (reg, sched, res)
    (jreg, jsched, jres), (reg, sched, res) = out["ref"], out["port"]
    for rid, r in jres.items():
        assert res[rid].finish_reason == r.finish_reason, rid
        same = res[rid].tokens == [int(x) for x in r.tokens]
        assert same != ((name, rid) in PARTED), (rid, res[rid].tokens,
                                                 r.tokens)
    assert reg.render() == jreg.render()
    text = reg.render()
    n_tok = sum(len(r.tokens) for r in res.values())
    assert reg.value("repro_tokens_generated_total") == n_tok
    assert reg.value("repro_prefill_tokens_total", {"source": "computed"}) \
        == sched.prefill_tokens_computed > 0
    assert reg.value("repro_active_lanes") == 0
    if name == "plain":
        assert reg.value("repro_requests_total", {"outcome": "length"}) == 3
        assert n_tok == 15 and reg.value("repro_requests_shed_total") == 0
        for stage in ("queue", "prefill", "decode"):
            assert f'repro_request_stage_seconds_bucket{{stage="{stage}"' \
                in text, stage
        assert "repro_request_ttft_seconds_count 3" in text
        assert "repro_request_e2e_seconds_count 3" in text
        assert "repro_request_itl_seconds_count 12" in text
    elif name == "robust":
        outcomes = {r.finish_reason for r in res.values()}
        assert {"shed", "deadline", "cancelled", "length"} <= outcomes
        assert reg.value("repro_requests_shed_total") == sched.shed_count >= 1
        assert reg.value("repro_deadline_expired_total") == 1
        assert reg.value("repro_fault_events_total") == \
            reg.value("repro_fault_recoveries_total") == 1
    elif name == "prefix":
        assert reg.value("repro_prefill_tokens_total", {"source": "cached"}) \
            == sched.prefix_hit_tokens == 64
    else:
        assert sched.spec_rounds > 0
        assert f"repro_spec_draft_seconds_count {sched.draft_launches}" \
            in text
        assert ("repro_spec_verify_seconds_count "
                f"{sched.spec_verify_launches}") in text
        assert f"repro_decode_step_seconds_count {sched.decode_launches}" \
            in text


def test_prefix_parting_is_a_prefill_near_tie(weights, engines):
    """The "prefix" scenario's third prompt (a 32-token prefix + 7 tokens)
    parts from the reference at its first token, with the prefix cache on
    or off, in the scheduler and in lockstep alike: the two prefills'
    logits differ by up to ~2e-2 (one int8 requantization flip carried by
    later layers, as in ROADMAP queue 3's entries), and the reference's
    top two are 5.9e-3 apart. Each side picks the other's runner-up."""
    from repro.serving.api import PooledEngine as JEngine

    jqp, _ = weights
    reqs, _ = _scenario_requests("prefix", "port")
    p = reqs[2].prompt
    jlog, _ = JEngine(JCFG, jqp, max_len=MAX_LEN).prefill(
        np.asarray(p)[None], len(p), {})
    jlog = np.asarray(jlog)[0]
    tlog = engines[True].prefill(p[None])[0][0].numpy()
    jtop, ttop = np.argsort(-jlog)[:2], np.argsort(-tlog)[:2]
    assert jtop.tolist() == ttop[::-1].tolist()
    assert jlog[jtop[0]] - jlog[jtop[1]] < 1e-2
    assert np.abs(jlog - tlog).max() < 3e-2
