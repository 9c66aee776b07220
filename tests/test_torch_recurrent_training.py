"""The recurrent families' training path and the int8 gradient
compression, held against the JAX reference on the CPU (the reference's
``value_and_grad`` under ``jax.jit``, the same seeded numpy inputs, the
reference's masters carried over by :mod:`repro_torch.convert`):

  * ``chunked_scan``: values and gradients against ``jax.grad`` of the
    reference's at T below, at and above the chunk (8) with a ragged
    tail; remat on and off, and nested inside a layer's checkpoint,
    bitwise in the port;
  * the training forms of ``rwkv_time_mix``, ``rwkv_channel_mix`` and
    ``mamba_forward`` at T 80 (chunk 64: one remat'd chunk and a ragged
    tail), and ``rwkv_layer_apply`` / ``superblock_apply``: values and
    every gradient within 1e-4;
  * reduced jamba at its full 2 superblocks parts from the reference
    only at knife-edges: the ``dt_proj`` inputs' exact ties (an 8-wide
    row of one integer product's multiples, x/scale = 127·I_j/I_max on a
    half-integer, resolved by each side's summation order) and one
    near-tie in block 1's attention input, x/scale within 3e-5 of −3.5;
  * ``compressed_psum`` on a single-process mesh of 8 shards bitwise the
    reference's under ``jax.vmap(..., axis_name="data")``: one shot, 16
    rounds of error feedback (whose running mean converges, the
    reference's ``collectives_check``), ``compressed_psum_tree``;
  * one data-parallel step of reduced rwkv6 with ``CompressedMean`` over
    2 gloo ranks bitwise the same step on a single-process mesh;
  * train → quantize → serve for reduced rwkv6 and jamba (the Scheduler's
    tokens == lockstep's on the trained tree), and the training CLI.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

import repro.core.ternary as jternary
import repro.models.layers as jlayers
from repro.distributed.compression import compressed_psum as jpsum
from repro.distributed.compression import compressed_psum_tree as jpsum_tree
from repro.models import mamba as jmamba
from repro.models import rwkv6 as jrwkv
from repro.models import transformer as jtransformer
from repro.models.scan_utils import chunked_scan as jchunked_scan
from repro_torch.configs import get_config
from repro_torch.convert import from_numpy_tree
from repro_torch.distributed.compression import (compressed_psum,
                                                 compressed_psum_tree,
                                                 init_error_state)
from repro_torch.launch.mesh import local_mesh, spawn_ranks
from repro_torch.launch.train import main, train_loop
from repro_torch.models import mamba, rwkv6, transformer
from repro_torch.models.scan_utils import chunked_scan, stepwise
from repro_torch.models.transformer import forward_train
from repro_torch.serving.api import GenerateRequest, PooledEngine
from repro_torch.serving.quantize import quantize_params
from repro_torch.serving.scheduler import Scheduler, lockstep_generate
from repro_torch.tree_util import flatten_with_path, leaves, tree_map

import torch_dp_rank as dp
from tests.test_models_smoke import _reduced
from torch_knife_edges import bitlinear_inputs, knife_edges

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
RWKV, JAMBA = "rwkv6-1.6b", "jamba-1.5-large-398b"


def _t(a):
    return torch.from_numpy(np.array(a))


def _pair(arch: str, **kw):
    return (_reduced(arch).replace(act_dtype="float32", **kw),
            get_config(f"{arch}-reduced").replace(act_dtype="float32", **kw))


def _keyed(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_grads(fn, params: dict, *inputs):
    """``fn(params, *inputs)`` → a tuple of tensors, backward of the sum of
    each times a fixed seeded cotangent. → (the outputs, {keystr: the
    gradient of each param leaf}, the inputs' gradients)."""
    for p in leaves(params):
        p.grad = None
        p.requires_grad_(True)
    xs = [x.clone().requires_grad_(True) for x in inputs]
    outs = fn(params, *xs)
    loss = sum((o * _cot(o.shape)).sum() for o in outs)
    loss.backward()
    grads = {k: v.grad for k, v in flatten_with_path(params)}
    for p in leaves(params):
        p.requires_grad_(False)
        p.grad = None
    return [o.detach() for o in outs], grads, [x.grad for x in xs]


def _cot(shape):
    rng = np.random.default_rng(sum(shape))
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _ref_grads(fn, params, *inputs):
    """The reference's counterpart of :func:`_port_grads` under
    ``jax.jit(jax.value_and_grad)``."""
    def loss(p, *xs):
        outs = fn(p, *xs)
        return sum(jnp.sum(o * jnp.asarray(_cot(o.shape).numpy()))
                   for o in outs), outs
    (_, outs), grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(1 + len(inputs))), has_aux=True))(
        params, *(jnp.asarray(x) for x in inputs))
    return outs, _keyed(grads[0]), grads[1:]


def _hold(port, ref):
    """Outputs, parameter and input gradients within ``TOL`` (a master
    the port's graph does not reach against the reference's zeros)."""
    (outs, grads, xgrads), (jouts, jgrads, jxgrads) = port, ref
    for o, jo in zip(outs, jouts):
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    assert sorted(grads) == sorted(jgrads)
    for k, want in jgrads.items():
        got = np.zeros_like(want) if grads[k] is None else grads[k].numpy()
        np.testing.assert_allclose(got, want, **TOL, err_msg=k)
    for g, jg in zip(xgrads, jxgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), **TOL)


def _j_record(rec: list, x, w, per_channel: bool, i=None):
    """Record the reference's BitLinear call as ``tests/torch_knife_
    edges.py`` records the port's, [x, w, γ·t], when the compiled code
    runs: at ``rec[i]``, or appended."""
    def put(*a):
        a = [np.array(v) for v in a]
        rec.append(a) if i is None else rec.__setitem__(i, a)
    jax.debug.callback(put, x, w, jternary.ste_ternary(
        w, per_channel=per_channel), ordered=True)


def _held_at_port_int8(monkeypatch, port_fn, ref_fn, tp, jp, *inputs):
    """``port_fn`` against ``ref_fn`` (values and gradients, ``_hold``)
    with the reference taking the port's int8 activations: every QAT
    BitLinear input of the port's forward is recorded, and the
    reference's input at the same call is replaced by it in value (its
    own gradient kept: x + stop_gradient(x_port − x)). Each call's int8
    values and ternary codes may part from the reference's own only at
    knife-edges (``knife_edges``, x/scale within 1e-4 of a half-integer),
    where the two sides' f32 summation orders round an exact or near tie
    apart; with one side's choice on both, the rest of the computation is
    held at 1e-4. → the int8 knife-edges found."""
    rec_j, j_orig = [], jlayers.bitlinear_qat
    with torch.no_grad(), bitlinear_inputs() as rec_t:
        port_fn(tp, *(_t(a) for a in inputs))
    got = _port_grads(port_fn, tp, *(_t(a) for a in inputs))

    def j_sub(x, w, per_channel=False):
        ours = jnp.asarray(rec_t[len(rec_j)][0].numpy())
        rec_j.append(None)
        _j_record(rec_j, x, w, per_channel, len(rec_j) - 1)
        return j_orig(x + jax.lax.stop_gradient(ours - x), w, per_channel)
    monkeypatch.setattr(jlayers, "bitlinear_qat", j_sub)
    want = _ref_grads(ref_fn, jp, *inputs)
    jax.effects_barrier()
    assert len(rec_j) == len(rec_t) > 0
    edges = knife_edges(rec_t, rec_j, 1e-4)[0]
    _hold(got, want)
    return edges


# ---------------------------------------------------------------------------
# chunked_scan
# ---------------------------------------------------------------------------

def _body_t(c, x):
    return c * x[0] + torch.tanh(x[1]), c * 2.0 + x[0] * x[1]


def _body_j(c, x):
    return c * x[0] + jnp.tanh(x[1]), c * 2.0 + x[0] * x[1]


def _scan_inputs(t):
    rng = np.random.default_rng(t)
    return (rng.standard_normal((2, 3)).astype(np.float32),
            rng.uniform(0.5, 1.0, (t, 2, 3)).astype(np.float32),
            rng.standard_normal((t, 2, 3)).astype(np.float32))


@pytest.mark.parametrize("t", [5, 8, 20], ids=["below", "at", "ragged"])
def test_chunked_scan_grads_match_reference(t):
    """At chunk 8: the carry, every y and the gradients of carry0 and of
    both inputs against ``jax.grad`` of the reference's remat'd scan,
    within 1e-6 (XLA contracts a product feeding a sum into one fused
    multiply-add); remat on and off bitwise in the port."""
    c0, a, b = _scan_inputs(t)

    def port(remat):
        return _port_grads(lambda _, c, x0, x1: chunked_scan(
            stepwise(_body_t), c, (x0, x1), chunk=8, remat=remat), {},
            _t(c0), _t(a), _t(b))
    got = port(True)
    want = _ref_grads(lambda _, c, x0, x1: jchunked_scan(
        _body_j, c, (x0, x1), chunk=8), {}, c0, a, b)
    for o, jo in zip(got[0], want[0]):
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-6,
                                   atol=1e-6)
    for g, jg in zip(got[2], want[2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6,
                                   atol=1e-6)
    plain = port(False)
    for x, y in zip(got[0] + got[2], plain[0] + plain[2]):
        assert torch.equal(x, y)


def test_chunked_scan_remat_nests_in_a_layer_checkpoint():
    """The chunks' checkpoints inside an outer non-reentrant checkpoint
    (``_scan_stack``'s per layer) give values and gradients bitwise those
    of no remat at all."""
    c0, a, b = _scan_inputs(20)

    def run(fn):
        return _port_grads(lambda _, c, x0, x1: fn(c, x0, x1), {},
                           _t(c0), _t(a), _t(b))

    def scan(remat):
        return lambda c, x0, x1: chunked_scan(stepwise(_body_t), c,
                                              (x0, x1), chunk=8, remat=remat)
    nested = run(lambda *args: checkpoint(scan(True), *args,
                                          use_reentrant=False))
    plain = run(scan(False))
    for x, y in zip(nested[0] + nested[2], plain[0] + plain[2]):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the training mixers and layers
# ---------------------------------------------------------------------------

def _x(cfg, t, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((2, t, cfg.d_model)).astype(np.float32)


def _rwkv_masters(jcfg):
    jp, _ = jtransformer.rwkv_layer_init(jax.random.PRNGKey(1), jcfg)
    return jp, from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu")


def test_rwkv_time_mix_trains_as_reference(monkeypatch):
    """T 80 (one remat'd chunk of 64 and a ragged tail of 16) from a
    seeded token shift and state: out, last x and the state, and the
    gradients of every master, x, x_prev and state0 within 1e-4
    (``_held_at_port_int8``; no knife-edge here)."""
    jcfg, cfg = _pair(RWKV)
    jp, tp = _rwkv_masters(jcfg)
    rng = np.random.default_rng(2)
    xp = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    s0 = (rng.standard_normal((2, cfg.n_heads, cfg.hd, cfg.hd)) * 0.1
          ).astype(np.float32)
    assert _held_at_port_int8(
        monkeypatch, lambda p, *a: rwkv6.rwkv_time_mix(cfg, p, *a,
                                                       train=True),
        lambda p, *a: jrwkv.rwkv_time_mix(jcfg, p, *a, chunk=64),
        tp["tm"], jp["tm"], _x(cfg, 80), xp, s0) == 0


def test_rwkv_channel_mix_trains_as_reference(monkeypatch):
    """T 80: out and last x, the gradients of every master (the time
    mix's zero on both sides) and of x and x_prev within 1e-4."""
    jcfg, cfg = _pair(RWKV)
    jp, tp = _rwkv_masters(jcfg)
    xp = np.random.default_rng(3).standard_normal(
        (2, 1, cfg.d_model)).astype(np.float32)
    assert _held_at_port_int8(
        monkeypatch, lambda p, *a: rwkv6.rwkv_channel_mix(cfg, p, *a,
                                                          train=True),
        lambda p, *a: jrwkv.rwkv_channel_mix(jcfg, p, *a),
        tp["tm"], jp["tm"], _x(cfg, 80), xp) == 0


def test_rwkv_layer_apply_trains_as_reference(monkeypatch):
    """A whole rwkv6 layer at T 80 from zero shift and state: x and every
    master's gradient within 1e-4."""
    jcfg, cfg = _pair(RWKV)
    jp, tp = _rwkv_masters(jcfg)
    assert _held_at_port_int8(
        monkeypatch, lambda p, x: (transformer.rwkv_layer_apply(cfg, p, x),),
        lambda p, x: (jtransformer.rwkv_layer_apply(jcfg, p, x),),
        tp, jp, _x(cfg, 80)) == 0


def _mamba_masters(jcfg):
    jp, _ = jmamba.mamba_init(jax.random.PRNGKey(4), jcfg)
    return jp, from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu")


def test_softplus_gradient_matches_reference():
    """``mamba.softplus``'s values bitwise ``jax.nn.softplus``'s forms
    and its gradient ``jax.grad``'s, at 0 too (½: a ``dt_proj`` column of
    ternary zeros puts every token there; ``abs``'s sign(0) = 0 had left
    ``clamp_min``'s 1), past ±20 and at −0."""
    x = np.array([0.0, -0.0, 1e-30, -1e-30, 0.5, -3.0, 19.0, 21.0, -25.0,
                  88.0], np.float32)
    t = _t(x).requires_grad_(True)
    y = mamba.softplus(t)
    y.sum().backward()
    jg = jax.grad(lambda a: jax.nn.softplus(a).sum())(jnp.asarray(x))
    np.testing.assert_allclose(y.detach().numpy(),
                               np.asarray(jax.nn.softplus(x)), rtol=1e-7)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=1e-7)
    assert t.grad[0] == 0.5 and t.grad[1] == 0.5


def test_mamba_forward_trains_as_reference(monkeypatch):
    """The training ``mamba_forward`` at T 80 (chunk 64): out and the ssm
    and conv states, and the gradients of every master (``dt_proj`` and
    its bias through the QAT BitLinear) and of u within 1e-4, on the
    port's int8 activations. ``dt_proj``'s input (k = dt_rank 8) is
    x_proj's output row, one scale times integer sums, so x/scale =
    127·I_j/I_max sits exactly on a half-integer now and then, which each
    side's summation order rounds its own way: such ties are the only
    partings."""
    jcfg, cfg = _pair(JAMBA)
    jp, tp = _mamba_masters(jcfg)

    def port(p, u):
        y, st = mamba.mamba_forward(cfg, p, u, train=True)
        return y, st["ssm"], st["conv"]

    def ref(p, u):
        y, st = jmamba.mamba_forward(jcfg, p, u, chunk=64)
        return y, st["ssm"], st["conv"]
    _held_at_port_int8(monkeypatch, port, ref, tp, jp, _x(cfg, 80))


def test_superblock_apply_trains_as_reference(monkeypatch):
    """One superblock of reduced jamba (Mamba; Mamba + MoE; attention +
    FFN; Mamba + MoE) at T 32: x and the summed MoE aux, every master's
    gradient and x's within 1e-4, on the port's int8 activations (their
    partings knife-edges only: one f32 near-tie flipped unchecked
    reaches ~1e-2 through the Mamba recurrences)."""
    jcfg, cfg = _pair(JAMBA)
    jp, _ = jtransformer.superblock_init(jax.random.PRNGKey(5), jcfg)
    tp = from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu")
    pos = np.arange(32)[None]
    _held_at_port_int8(
        monkeypatch, lambda p, x: transformer.superblock_apply(
            cfg, p, x, positions=torch.from_numpy(pos)),
        lambda p, x: jtransformer.superblock_apply(
            jcfg, p, x, positions=jnp.asarray(pos)), tp, jp, _x(cfg, 32))


def test_hybrid_parts_from_reference_only_at_knife_edges(monkeypatch):
    """Reduced jamba at its 2 superblocks, f32, the training batch of
    ``test_loss_and_grads_match_reference_f32`` (which holds the
    gradients at one superblock): every QAT BitLinear input recorded on
    both sides (22 a superblock), each side on its own forward. Up to the
    first parting that is not one of ``dt_proj``'s exact ties, every
    parting is a knife-edge (``knife_edges``); measured here: the ties
    of 5 of the 6 ``dt_proj`` inputs (1–3 elements each), then block 1's
    attention input (Q, K and V share it) in one element, x/scale
    −3.500019 / −3.499989 with the f32 inputs 3e-6 apart after seven
    sublayers: rounding, not a fault. The layers after it carry the
    flip (the logits part by ~2e-2), the loss within 1e-5."""
    from tests.test_torch_training import _family_batch
    jcfg, cfg = _pair(JAMBA)
    jp, _ = jtransformer.init_params(jcfg, jax.random.PRNGKey(0))
    tp = from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu")
    batch = _family_batch(cfg, JAMBA)
    rec_j, j_orig = [], jternary.bitlinear_qat

    def j_rec(x, w, per_channel=False):
        _j_record(rec_j, x, w, per_channel)
        return j_orig(x, w, per_channel)
    monkeypatch.setattr(jlayers, "bitlinear_qat", j_rec)
    jlog, _ = jax.jit(lambda p, t: jtransformer.forward_train(
        jcfg, p, t, remat=False))(jp, jnp.asarray(batch["tokens"]))
    jax.block_until_ready(jlog)
    jax.effects_barrier()
    with torch.no_grad(), bitlinear_inputs() as rec_t:
        logits, _ = forward_train(cfg, tp, _t(batch["tokens"]), remat=False)
    assert len(rec_j) == len(rec_t) == 22 * 2
    for a, b in zip(rec_t, rec_j):
        if sum(knife_edges([a], [b], 1e-4)[:2]) and \
                a[0].shape[-1] != mamba.dt_rank(cfg):
            break
    vmask = np.arange(cfg.vocab_padded) < cfg.vocab
    jl, tl = np.asarray(jlog)[..., vmask], logits.numpy()[..., vmask]

    def ce(lg):
        lg = lg - lg.max(-1, keepdims=True)
        lp = lg - np.log(np.exp(lg).sum(-1, keepdims=True))
        return -np.take_along_axis(lp, batch["labels"][..., None],
                                   -1).mean()
    np.testing.assert_allclose(ce(tl), ce(jl), rtol=1e-5)


# ---------------------------------------------------------------------------
# the int8 gradient compression
# ---------------------------------------------------------------------------

def _shards(seed, shape=(8, 64)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_compressed_psum_bitwise_reference_on_eight_shards():
    """8 shards of 64 (the reference's ``collectives_check``): the first
    round's sum and error state bitwise the reference's under
    ``jax.vmap(..., axis_name="data")`` and within 2 % of the exact sum;
    16 rounds of error feedback bitwise round by round, the running mean's
    error at the last round below half the first's; then a tree of three
    leaves with their own error states."""
    x = _shards(0)
    mesh = local_mesh((8,), ("data",))
    jf = jax.jit(jax.vmap(lambda a, e: jpsum(a, "data", e),
                          axis_name="data"))
    exact = x.sum(0)

    def rounds(n):
        err_j, err_t = jnp.zeros_like(x), torch.zeros(8, 64)
        for _ in range(n):
            tot_j, err_j = jf(jnp.asarray(x), err_j)
            tot_t, err_t = compressed_psum(_t(x), "data", err_t, mesh)
            assert tot_t.shape == (1, 64)
            assert np.array_equal(np.broadcast_to(tot_t.numpy(), (8, 64)),
                                  np.asarray(tot_j))
            assert np.array_equal(err_t.numpy(), np.asarray(err_j))
            yield tot_t.numpy()[0]
    one, = rounds(1)
    assert np.abs(one - exact).max() / np.abs(exact).max() < 0.02
    running, mean_err = np.zeros(64, np.float64), []
    for i, tot in enumerate(rounds(16), 1):
        running += tot
        mean_err.append(np.abs(running / i - exact).max())
    assert mean_err[-1] < 0.5 * mean_err[0], mean_err
    tree = {"a": _shards(1, (8, 5, 7)), "b": {"c": _shards(2, (8, 3)),
                                              "d": _shards(3, (8, 2, 2, 2))}}
    ttree = tree_map(_t, tree)
    err = init_error_state(ttree)
    jerr = jax.tree.map(jnp.zeros_like, tree)
    jt = jax.jit(jax.vmap(lambda g, e: jpsum_tree(g, "data", e),
                          axis_name="data"))
    for _ in range(2):
        tot, err = compressed_psum_tree(ttree, "data", err, mesh)
        jtot, jerr = jt(jax.tree.map(jnp.asarray, tree), jerr)
        for (k, got), want in zip(flatten_with_path(tot),
                                  jax.tree.leaves(jtot)):
            assert np.array_equal(np.broadcast_to(
                got.numpy(), want.shape), np.asarray(want)), k
        for got, want in zip(leaves(err), jax.tree.leaves(jerr)):
            assert np.array_equal(got.numpy(), np.asarray(want))


def test_data_parallel_step_over_gloo_bitwise_local_mesh():
    """Reduced rwkv6 at f32, batch 8 × 32 (``tests/torch_dp_rank.py``): 2
    gloo ranks, each stepping on its half with ``CompressedMean``, end
    with masters bitwise equal to each other and to the single-process
    mesh's step (``dp.dp_step``), which moved them."""
    ranks = spawn_ranks("torch_dp_rank:dp_rank", dp.WORLD, timeout=600)
    cfg, params, batch = dp.setup()
    p0 = {k: v.clone() for k, v in flatten_with_path(params)}
    local, m = dp.dp_step(cfg, params, batch, local_mesh((2,), ("data",)))
    local = dict(flatten_with_path(local))
    for k, want in local.items():
        assert torch.equal(ranks[0][k], want), k
        assert torch.equal(ranks[1][k], want), k
    assert any(not torch.equal(local[k], p0[k]) for k in p0)
    assert np.isfinite(float(m["loss"]))


# ---------------------------------------------------------------------------
# train → quantize → serve, the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [RWKV, JAMBA])
def test_train_quantize_serve(arch):
    """10 QAT steps of the reduced config (batch 4 × 32, lr 3e-3) through
    ``train_loop``: the loss falls (the last 5 steps' mean below the
    first 5's); the trained masters quantize and serve (the Scheduler's
    tokens == lockstep's)."""
    cfg = get_config(f"{arch}-reduced")
    out = train_loop(cfg, steps=10, global_batch=4, seq_len=32,
                     peak_lr=3e-3, log_every=1000, device="cpu")
    assert np.mean(out["losses"][-5:]) < np.mean(out["losses"][:5])
    qp = quantize_params(cfg, out["params"])
    engine = PooledEngine(cfg, qp, max_len=63, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (12, 20)]
    want = [lockstep_generate(engine, p, 4) for p in prompts]
    sched = Scheduler(engine, n_slots=2)
    for rid, p in enumerate(prompts):
        sched.submit(GenerateRequest(rid=rid, prompt=p, max_new_tokens=4))
    got = {r.rid: r.tokens for r in sched.run_to_completion()}
    assert [got[0], got[1]] == want
    assert all(len(t) == 4 for t in want)


def test_train_cli_trains_rwkv6_on_the_cpu(capsys):
    assert main(["--arch", RWKV, "--reduced", "--device", "cpu", "--steps",
                 "12", "--seq", "32", "--global-batch", "4", "--lr",
                 "3e-3"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("training rwkv6-1.6b-reduced (ssm) for 12 "
                             "steps, batch 4 × seq 32")
    first, last = (float(x) for x in out[-1].split()[1:4:2])
    assert last < first, out[-1]
