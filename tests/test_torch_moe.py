"""The port's MoE family on ``granite-moe-1b-a400m-reduced`` (3 layers, d
96, 8 experts top-4, ``moe_group`` 64) held against the JAX reference on
the CPU:

  * #1 and #2 with a leading expert axis (E > 1): the plain versions
    against the reference's interpret-mode Pallas kernels, f32 at rtol =
    atol = 2e-5, zero rows exact zeros;
  * one dispatch group: the dispatched expert rows xe [E, cap, d] (which
    token sits in which capacity slot, i.e. the choices, positions and
    keep mask) bitwise the reference's ``_dispatch_group``'s, including a
    router biased into overflow drops; the layer's output within rtol =
    atol = 2e-5 (f32 router and combine sums in another order: ulps);
  * the whole layer with a padded tail group, and zero pad rows (the only
    exact router ties) never moving a real token;
  * the converted and the port's own quantized trees;
  * greedy tokens: the port's Scheduler (run-to-completion regime, exact
    prompt lengths) equals the reference's ``lockstep_generate`` on the
    converted weights, with the reference's own MoE scheduler cases, and
    the port's lockstep bitwise, greedy and sampled;
  * the one stream known to part from the reference: where it parts, and
    that the attention's int8 K/V, not the routing, parts first;
  * the chunked-only entries raise for moe, and the serve launcher runs
    the reduced model end to end.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.granite_moe_1b_a400m import REDUCED as JCFG
from repro.kernels import ops as jops
from repro.models import moe as jmoe
from repro.models.transformer import init_params as jinit
from repro.serving.quantize import quantize_params as jquantize
from repro.serving.scheduler import lockstep_generate as jlockstep
from repro_torch.configs import get_config
from repro_torch.convert import from_numpy_tree
from repro_torch.core.qlinear import qlinear_expert
from repro_torch.kernels import ops as tops
from repro_torch.models import moe as tmoe
from repro_torch.models.transformer import init_params
from repro_torch.serving import engine as teng
from repro_torch.serving.api import (GenerateRequest, PooledEngine,
                                     SamplingParams)
from repro_torch.serving.quantize import quantize_params
from repro_torch.serving.scheduler import Scheduler, lockstep_generate

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)
MAX_LEN = 63          # pool capacity 64 with the reduced lop_block of 32
CFG = get_config("granite-moe-1b-a400m-reduced")


@pytest.fixture(scope="module")
def weights():
    params, _ = jinit(JCFG, jax.random.PRNGKey(0))
    jqp = jquantize(JCFG, params)
    return jqp, from_numpy_tree(jax.tree.map(np.asarray, jqp), "cpu")


def _layer(tree, i=0):
    return {k: v[i] for k, v in tree["layers"]["moe"].items()}


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# #1 and #2 with the expert axis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("e,c,k,n,bias", [(4, 6, 64, 96, False),
                                          (8, 9, 96, 64, True),
                                          (3, 1, 128, 40, False)])
def test_expert_qlinear_plain_vs_pallas(e, c, k, n, bias):
    rng = np.random.default_rng(e * 100 + c)
    x = rng.standard_normal((e, c, k)).astype(np.float32)
    x[:, c // 2 + 1:] = 0.0                      # empty capacity slots
    packed = rng.integers(0, 256, (e, k // 4, n)).astype(np.uint8)
    scale = rng.uniform(0.01, 0.05, (e, 1, n)).astype(np.float32)
    b = (rng.standard_normal((e, 1, n)).astype(np.float32) * 0.1
         if bias else None)
    want = jops.qlinear_fused(jnp.asarray(x), jnp.asarray(packed),
                              jnp.asarray(scale),
                              None if b is None else jnp.asarray(b),
                              impl="pallas")
    node = {"packed": _t(packed), "scale": _t(scale)}
    if bias:
        node["b"] = _t(b)
    got = qlinear_expert(node, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if not bias:
        assert not got[:, c // 2 + 1:].any()


@pytest.mark.parametrize("e,c,d,f", [(3, 5, 64, 128), (8, 9, 96, 64)])
def test_expert_ffn_plain_vs_pallas(e, c, d, f):
    rng = np.random.default_rng(e * 10 + c)
    x = rng.standard_normal((e, c, d)).astype(np.float32)
    x[:, c - 2:] = 0.0
    gu = rng.integers(0, 256, (e, d // 4, 2 * f)).astype(np.uint8)
    gs = rng.uniform(0.01, 0.05, (e, 1, 2 * f)).astype(np.float32)
    down = rng.integers(0, 256, (e, f // 4, d)).astype(np.uint8)
    ds = rng.uniform(0.01, 0.05, (e, 1, 1)).astype(np.float32)
    want = jops.ffn_fused(*map(jnp.asarray, (x, gu, gs, down, ds)),
                          gated=True, act="silu", impl="pallas")
    got = tops.ffn_fused(*map(_t, (x, gu, gs, down, ds)), gated=True,
                         act="silu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not got[:, c - 2:].any()


# ---------------------------------------------------------------------------
# routing and dispatch
# ---------------------------------------------------------------------------

def _dispatched(monkeypatch, module, fn, *args):
    """Run ``fn(*args)`` with ``module.ffn_node_apply`` recording the
    expert rows it is given. → (fn's result, the recorded rows)."""
    seen = []
    real = module.ffn_node_apply

    def spy(p, xe, **kw):
        seen.append(np.array(xe))
        return real(p, xe, **kw)
    monkeypatch.setattr(module, "ffn_node_apply", spy)
    out = fn(*args)
    monkeypatch.setattr(module, "ffn_node_apply", real)
    return out, seen


@pytest.mark.parametrize("t,bias", [(1, 0.0), (4, 0.0), (37, 0.0),
                                    (64, 0.0), (64, 0.6)],
                         ids=["t1", "t4", "t37", "t64", "t64-drops"])
def test_dispatch_group_bitwise_reference(weights, monkeypatch, t, bias):
    jqp, tqp = weights
    jp, tp = _layer(jqp), _layer(tqp)
    x = np.random.default_rng(t).standard_normal((t, CFG.d_model)).astype(
        np.float32)
    if bias:
        # rows with a common positive part and a router leaning on their
        # sum: every token picks expert 0, past its capacity
        jp = dict(jp, router=jp["router"].at[:, 0].add(bias))
        tp = dict(tp, router=tp["router"].clone())
        tp["router"][:, 0] += bias
        x += 1.0
    (jy, _), jxe = _dispatched(monkeypatch, jmoe, jmoe._dispatch_group,
                               JCFG, jp, jnp.asarray(x))
    ty, txe = _dispatched(monkeypatch, tmoe, tmoe.dispatch_group, CFG, tp,
                          _t(x))
    assert len(jxe) == len(txe) == 1
    np.testing.assert_array_equal(txe[0], jxe[0])
    keep = tmoe.route(CFG, tp["router"], _t(x))[3]
    if t <= 8 or bias:           # decode groups are drop-free
        assert bool(keep.all()) == (not bias)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)


@pytest.mark.parametrize("t", [64, 100, 150])
def test_moe_apply_groups_and_padded_tail(weights, t):
    """Groups of ``moe_group`` (64) tokens, the tail zero-padded; every
    layer of the tree."""
    jqp, tqp = weights
    x = np.random.default_rng(t).standard_normal(
        (1, t, CFG.d_model)).astype(np.float32)
    for i in range(CFG.n_layers):
        want, _ = jmoe.moe_apply(JCFG, _layer(jqp, i), jnp.asarray(x))
        got = tmoe.moe_apply(CFG, _layer(tqp, i), _t(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_zero_pad_rows_never_move_a_real_token(weights):
    """Zero pad rows tie on every expert (all logits 0), where
    ``torch.topk`` promises no order; they come after every real token in
    the token-major capacity order, so the real tokens' choices,
    positions and keep mask are the same whatever the pad rows pick."""
    _, tqp = weights
    p = _layer(tqp)
    rng = np.random.default_rng(5)
    real = rng.standard_normal((40, CFG.d_model)).astype(np.float32)
    zeros = np.zeros((24, CFG.d_model), np.float32)
    other = rng.standard_normal((24, CFG.d_model)).astype(np.float32) * 3
    a = tmoe.route(CFG, p["router"], _t(np.concatenate([real, zeros])))
    b = tmoe.route(CFG, p["router"], _t(np.concatenate([real, other])))
    assert a[4] == b[4]
    for u, v in zip(a[:4], b[:4]):
        assert torch.equal(u[:40], v[:40])
    # the zero rows' gates are uniform: an exact tie across all experts
    assert torch.equal(a[0][40:], torch.full_like(a[0][40:], 1 / CFG.top_k))


def test_capacity_is_the_reference_arithmetic():
    for t in (1, 2, 4, 7, 8, 9, 16, 64, 1536, 2048):
        for cfg in (CFG, get_config("granite-moe-1b-a400m"),
                    get_config("mixtral-8x22b")):
            e, k = cfg.n_experts, cfg.top_k
            want = int(max(-(-t * k * cfg.capacity_factor // e), k,
                           min(t, 8)))
            assert tmoe.capacity(cfg, t) == want
    # decode groups of up to 8 lanes are drop-free: cap >= t
    assert all(tmoe.capacity(get_config("granite-moe-1b-a400m"), t) >= t
               for t in range(1, 9))


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def test_converted_and_own_trees_agree_in_layout(weights):
    """The reference's quantized moe tree converts leaf for leaf; the
    port's own init → quantize builds the same leaves, shapes and dtypes
    (γ per expert and stream: gu [E, 1, 2f] per column, down [E, 1, 1];
    the router f32)."""
    _, tqp = weights
    own = quantize_params(CFG, init_params(CFG, 0, "cpu"))
    e, d, f, n = CFG.n_experts, CFG.d_model, CFG.d_ff, CFG.n_layers
    want = {"router": ((n, d, e), torch.float32),
            "gu_packed": ((n, e, d // 4, 2 * f), torch.uint8),
            "gu_scale": ((n, e, 1, 2 * f), torch.float32),
            "down_packed": ((n, e, f // 4, d), torch.uint8),
            "down_scale": ((n, e, 1, 1), torch.float32)}
    for tree in (tqp, own):
        got = {k: (tuple(v.shape), v.dtype)
               for k, v in tree["layers"]["moe"].items()}
        assert got == want
        assert "ffn" not in tree["layers"]
    # each expert's gate and up halves carry their own scalar γ
    gs = own["layers"]["moe"]["gu_scale"]
    assert torch.equal(gs[..., :f], gs[..., :1].expand_as(gs[..., :f]))
    assert torch.equal(gs[..., f:], gs[..., f:f + 1].expand_as(gs[..., f:]))


def test_quantize_codes_match_reference():
    """The port's quantizer on the reference's master expert stacks: the
    packed codes bitwise, γ (a mean, whose last bit follows the summation
    order) within 1e-6."""
    params, _ = jinit(JCFG, jax.random.PRNGKey(1))
    jq = jquantize(JCFG, params)["layers"]["moe"]
    master = from_numpy_tree(jax.tree.map(np.asarray, params), "cpu")
    tq = quantize_params(CFG, master)["layers"]["moe"]
    for key in ("gu_packed", "down_packed"):
        np.testing.assert_array_equal(tq[key].numpy(), np.asarray(jq[key]))
    for key in ("gu_scale", "down_scale"):
        np.testing.assert_allclose(tq[key].numpy(), np.asarray(jq[key]),
                                   rtol=1e-6)
    np.testing.assert_array_equal(tq["router"].numpy(),
                                  np.asarray(jq["router"]))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _prompts(lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab, (n,)).astype(np.int32) for n in lens]


@pytest.mark.parametrize("lens,seed,gen", [([17, 23], 11, 5),
                                           ([12, 27, 9, 33, 17], 3, 6)],
                         ids=["moe-exact-length", "staggered"])
def test_scheduler_tokens_match_reference_lockstep(weights, lens, seed, gen):
    """The reference's own scheduler cases (``tests/test_scheduler.py``):
    run-to-completion prefill at exact lengths on 2 slots, greedy; every
    request's tokens equal the reference's lockstep and the port's."""
    jqp, tqp = weights
    eng = PooledEngine(CFG, tqp, max_len=MAX_LEN, device="cpu")
    prompts = _prompts(lens, seed)
    sched = Scheduler(eng, n_slots=2, check_invariants=True,
                      spec_decode=True)
    assert not sched.chunked and sched.prefix_store is None
    assert not sched.spec                   # moe does not speculate
    for rid, p in enumerate(prompts):
        sched.submit(GenerateRequest(rid=rid, prompt=p, max_new_tokens=gen))
    got = {r.rid: r.tokens for r in sched.run_to_completion()}
    assert sched.full_prefill_stalls >= 1
    assert sched.prefill_tokens_computed == sum(lens)
    for rid, p in enumerate(prompts):
        assert got[rid] == jlockstep(JCFG, jqp, p, gen, max_len=MAX_LEN), rid
        assert got[rid] == lockstep_generate(eng, p, gen), rid


@pytest.mark.parametrize("lens,seed,gen", [([17, 23], 11, 5),
                                           ([12, 27, 9, 33, 17], 3, 6)],
                         ids=["moe-exact-length", "staggered"])
def test_shared_select_scheduler_matches_reference_lockstep(weights, lens,
                                                            seed, gen):
    """The same cases with ``gqa_shared_select=True`` (one LOP candidate
    set per kv head, G = 2): the scheduler's tokens equal the reference's
    lockstep and the port's."""
    jqp, tqp = weights
    cfg = CFG.replace(gqa_shared_select=True)
    eng = PooledEngine(cfg, tqp, max_len=MAX_LEN, device="cpu")
    prompts = _prompts(lens, seed)
    sched = Scheduler(eng, n_slots=2, check_invariants=True)
    for rid, p in enumerate(prompts):
        sched.submit(GenerateRequest(rid=rid, prompt=p, max_new_tokens=gen))
    got = {r.rid: r.tokens for r in sched.run_to_completion()}
    jcfg = JCFG.replace(gqa_shared_select=True)
    for rid, p in enumerate(prompts):
        assert got[rid] == jlockstep(jcfg, jqp, p, gen, max_len=MAX_LEN), rid
        assert got[rid] == lockstep_generate(eng, p, gen), rid


def test_sampled_scheduler_matches_lockstep(weights):
    _, tqp = weights
    eng = PooledEngine(CFG, tqp, max_len=MAX_LEN, device="cpu")
    prompts = _prompts([21, 8, 30], 9)
    sched = Scheduler(eng, n_slots=2, check_invariants=True)
    reqs = [GenerateRequest(rid=rid, prompt=p, max_new_tokens=7,
                            sampling=SamplingParams(temperature=0.8,
                                                    top_k=20, top_p=0.9,
                                                    seed=rid))
            for rid, p in enumerate(prompts)]
    for r in reqs:
        sched.submit(r)
    got = {r.rid: r.tokens for r in sched.run_to_completion()}
    for r in reqs:
        assert got[r.rid] == lockstep_generate(eng, r.prompt, 7,
                                               sampling=r.sampling)


def _route_f32(cfg, router, x):
    """``tmoe.route`` with the router product, softmax and gate sum in
    f32, as the reference writes them."""
    t = x.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    cap = tmoe.capacity(cfg, t)
    vals, expert = torch.topk(torch.softmax(x @ router, -1), k, dim=-1)
    gates = vals / torch.clamp_min(vals.sum(-1, keepdim=True),
                                   torch.tensor(1e-9))
    onehot = (expert[..., None] == torch.arange(e)).to(torch.int32)
    flat = onehot.reshape(t * k, e)
    pos = ((torch.cumsum(flat, 0) - flat).reshape(t, k, e) * onehot).sum(-1)
    return gates, expert, pos, pos < cap, cap


@pytest.mark.parametrize("router", ["float64", "float32"])
def test_parting_from_reference_starts_in_attention(weights, router):
    """The one greedy stream known to part from the reference (the third
    prompt of ``default_rng(1)``, 31 tokens, 12 new): its first 9 tokens
    agree, the 10th differs, and every MoE dispatch up to the step that makes the first
    differing token picks bitwise the reference's experts, positions and
    keep mask. What parts first is the attention's int8 K/V, already in
    layer 0's prefill: one requantization flip of f32 values that differ
    by ulps (as in dense), which later layers and steps carry until a
    greedy choice turns. The router's precision is not the cause: an f32
    router (the reference's formulation) gives the same stream."""
    jqp, tqp = weights
    rng = np.random.default_rng(1)
    lens = rng.integers(5, 40, 3)
    prompt = [rng.integers(0, CFG.vocab, (int(n),)).astype(np.int32)
              for n in lens][2]
    n_new, n_layers = 12, CFG.n_layers
    rec = {side: {"route": [], "kv": []} for side in ("jax", "port")}

    def j_kv(fn):
        def wrapped(*a, **kw):
            jax.debug.callback(lambda k, v: rec["jax"]["kv"].append(
                (np.array(k), np.array(v))), a[2], a[3])
            return fn(*a, **kw)
        return wrapped

    def t_kv(fn):
        def wrapped(*a, **kw):
            rec["port"]["kv"].append((a[2].numpy().copy(),
                                      a[3].numpy().copy()))
            return fn(*a, **kw)
        return wrapped

    j_dispatch = jmoe._dispatch_group

    def j_group(cfg, p, x):
        t = x.shape[0]
        e, k = cfg.n_experts, cfg.top_k
        cap = tmoe.capacity(cfg, t)
        _, gi = jax.lax.top_k(jax.nn.softmax(x @ p["router"], axis=-1), k)
        onehot = jax.nn.one_hot(gi, e, dtype=jnp.int32)
        flat = onehot.reshape(t * k, e)
        pos = jnp.sum((jnp.cumsum(flat, 0) - flat).reshape(t, k, e)
                      * onehot, -1)
        jax.debug.callback(lambda *a: rec["jax"]["route"].append(
            tuple(np.array(u) for u in a)), gi, pos, pos < cap)
        return j_dispatch(cfg, p, x)

    t_route = _route_f32 if router == "float32" else tmoe.route

    def t_group(cfg, r, x):
        out = t_route(cfg, r, x)
        rec["port"]["route"].append(tuple(u.numpy().copy()
                                          for u in out[1:4]))
        return out

    eng = PooledEngine(CFG, tqp, max_len=MAX_LEN, device="cpu")
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jmoe, "_dispatch_group", j_group)
        for name in ("prefill_attention", "decode_attention"):
            m.setattr(jops, name, j_kv(getattr(jops, name)))
            m.setattr(tops, name, t_kv(getattr(tops, name)))
        m.setattr(tmoe, "route", t_group)
        jax.clear_caches()                # retrace with the recorders
        want = jlockstep(JCFG, jqp, prompt, n_new, max_len=MAX_LEN)
        got = lockstep_generate(eng, prompt, n_new)
    jax.clear_caches()
    assert len(prompt) == 31
    for side in rec.values():
        assert len(side["route"]) == len(side["kv"]) == n_new * n_layers
    parted = next((i for i in range(n_new) if got[i] != want[i]), None)
    assert parted == 9
    # every dispatch through the step that made the first differing token
    for i in range((parted + 1) * n_layers):
        for u, v in zip(rec["port"]["route"][i], rec["jax"]["route"][i]):
            np.testing.assert_array_equal(u, v, err_msg=f"dispatch {i}")
    kv_flip = next(i for i, (a, b) in enumerate(zip(rec["port"]["kv"],
                                                    rec["jax"]["kv"]))
                   if not (np.array_equal(a[0], b[0])
                           and np.array_equal(a[1], b[1])))
    # the first call: layer 0's prefill, whose int8 V parts in one element
    # while its K is bitwise
    assert kv_flip == 0


def test_moe_first_token_finish_in_admit(weights):
    """A request that finishes on its prefill token retires inside
    ``admit`` (run-to-completion) and is reported in the results."""
    _, tqp = weights
    eng = PooledEngine(CFG, tqp, max_len=MAX_LEN, device="cpu")
    sched = Scheduler(eng, n_slots=1)
    p = _prompts([10], 2)[0]
    sched.submit(GenerateRequest(rid=0, prompt=p, max_new_tokens=1))
    (res,) = sched.run_to_completion()
    assert res.tokens == lockstep_generate(eng, p, 1)
    assert res.finish_reason == "length" and sched.n_active == 0


def test_chunked_entries_raise_for_moe(weights):
    _, tqp = weights
    eng = PooledEngine(CFG, tqp, max_len=MAX_LEN, device="cpu")
    pool = eng.init_pool(1)
    with pytest.raises(NotImplementedError):
        eng.prefill_chunk(pool, 0, np.zeros((1, 32), np.int32), 0, 32, True)
    with pytest.raises(NotImplementedError):
        teng.serve_step(CFG, tqp, pool, torch.zeros((1, 1), dtype=torch.long),
                        n_layers=1)


def test_prefill_attends_the_prompt_roundup(weights, monkeypatch):
    """moe never chunks, so its prefill attention reads [0, round_up(S,
    lop_block)) of the cache, not the whole capacity."""
    _, tqp = weights
    seen = []
    real = teng.ops.prefill_attention

    def spy(qi, qsc, k_cache, *a, **kw):
        seen.append(k_cache.shape[2])
        return real(qi, qsc, k_cache, *a, **kw)
    monkeypatch.setattr(teng.ops, "prefill_attention", spy)
    teng.prefill(CFG, tqp, torch.zeros((1, 20), dtype=torch.long),
                 max_len=MAX_LEN)
    assert seen == [32] * CFG.n_layers


def test_serve_launcher_reduced_moe(capsys):
    from repro_torch.launch import serve
    rc = serve.main(["--arch", "granite-moe-1b-a400m", "--reduced",
                     "--device", "cpu", "--slots", "2", "--requests", "3",
                     "--min-prompt", "8", "--max-prompt", "24", "--gen", "4",
                     "--verify"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "scheduler vs lockstep token equivalence: OK" in out
    assert "full-prompt prefills" in out


def test_engine_flags_match_reference():
    """The capability declarations (``tests/test_serving_api.py``): dense
    chunks and caches prefixes; moe prefills at exact length, with no
    prefix store and no speculation."""
    from repro.serving.api import PooledEngine as JEngine
    for arch in ("bitnet-3b", "granite-moe-1b-a400m"):
        cfg = get_config(f"{arch}-reduced")
        jcfg = dataclasses.replace(JCFG, **dataclasses.asdict(cfg))
        ref = JEngine(jcfg, {}, max_len=MAX_LEN)
        eng = PooledEngine(cfg, {}, max_len=MAX_LEN, device="cpu")
        for flag in ("supports_chunked", "exact_length_prefill",
                     "prefix_block", "supports_speculative", "state_kind"):
            assert getattr(eng, flag) == getattr(ref, flag), (arch, flag)
