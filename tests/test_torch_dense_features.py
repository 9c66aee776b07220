"""The dense family's last two features in the port, held against the JAX
reference on the CPU: the QKV bias (qwen1.5-32b) and LayerNorm
(stablelm-1.6b).

  * the QKV bias: with a nonzero seeded ``b`` in ``wq/wk/wv`` of the same
    qwen1.5-32b-reduced master tree on both sides, the port's
    ``quantize_params`` gives the reference's ``attn.wqkv``: codes
    bitwise, ``b`` bitwise ``concat(bq, bk, bv)``, γ at rtol 1e-6 (a mean,
    whose last bits follow the summation order), and every other leaf as
    the reference's;
  * the port's seeded master trees have the reference's paths, shapes and
    dtypes (zero biases, LayerNorm ``b``);
  * ``norm_apply``'s LayerNorm (population variance) within 1e-6 of the
    reference's;
  * greedy tokens: the port's Scheduler (chunked prefill) equals the
    reference's ``lockstep_generate`` on converted weights, LOP and
    no-LOP, for stablelm-1.6b-reduced and qwen1.5-32b-reduced (nonzero
    biases);
  * with stablelm's norms' g and b perturbed (LayerNorm's affine part on
    the path), a 40-token stream parts from the reference's at its third
    token, and what parts first is two int8 V values of layer 0's prefill
    whose scaled f32 values sit on a rounding boundary (−22.499998 and 63.5): the 1-ulp requantization knife-edge
    of ROADMAP queue 3, carried by later layers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.qwen1_5_32b import REDUCED as JQWEN
from repro.configs.stablelm_1_6b import REDUCED as JSTABLE
from repro.models.layers import norm_apply as jnorm_apply
from repro.models.transformer import init_params as jinit
from repro.serving.quantize import quantize_params as jquantize
from repro.serving.scheduler import lockstep_generate as jlockstep
from repro_torch.configs import get_config
from repro_torch.convert import from_numpy_tree
from repro_torch.models.layers import norm_apply
from repro_torch.models.transformer import init_params
from repro_torch.serving.api import GenerateRequest, PooledEngine
from repro_torch.serving.quantize import quantize_params
from repro_torch.serving.scheduler import Scheduler, lockstep_generate

torch.set_num_threads(1)

MAX_LEN = 63          # pool capacity 64 with the reduced lop_block of 32
JCFGS = {"qwen1.5-32b-reduced": JQWEN, "stablelm-1.6b-reduced": JSTABLE}


def _flat(tree) -> dict:
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


def _with_qkv_bias(params, seed: int = 0):
    """The master tree with ``wq/wk/wv.b`` drawn as 0.02·N(0, 1) (numpy,
    seeded) in place of the reference's zeros."""
    rng = np.random.default_rng(seed)
    attn = dict(params["layers"]["attn"])
    for name in ("wq", "wk", "wv"):
        b = attn[name]["b"]
        attn[name] = dict(attn[name], b=jnp.asarray(
            rng.standard_normal(b.shape).astype(np.float32) * 0.02))
    return dict(params, layers=dict(params["layers"], attn=attn))


def _with_norms(params, seed: int = 1):
    """The master tree with every norm's g = 1 + 0.1·N(0, 1) and b =
    0.02·N(0, 1) (numpy, seeded) in place of ones and zeros."""
    rng = np.random.default_rng(seed)

    def draw(like, base, sd):
        return jnp.asarray(base + sd * rng.standard_normal(like.shape)
                           .astype(np.float32))

    def norm(node):
        return {"g": draw(node["g"], 1.0, 0.1), "b": draw(node["b"], 0.0,
                                                        0.02)}
    layers = dict(params["layers"], ln1=norm(params["layers"]["ln1"]),
                  ln2=norm(params["layers"]["ln2"]))
    return dict(params, ln_f=norm(params["ln_f"]), layers=layers)


@pytest.fixture(scope="module")
def qwen_master():
    params, _ = jinit(JQWEN, jax.random.PRNGKey(0))
    return _with_qkv_bias(params)


@pytest.fixture(scope="module")
def weights(qwen_master):
    """name → (reference serving tree, the same converted to the port)."""
    out = {}
    stable, _ = jinit(JSTABLE, jax.random.PRNGKey(0))
    for name, master in (("qwen1.5-32b-reduced", qwen_master),
                         ("stablelm-1.6b-reduced", _with_norms(stable))):
        jqp = jquantize(JCFGS[name], master)
        out[name] = (jqp, from_numpy_tree(jax.tree.map(np.asarray, jqp),
                                          "cpu"))
    return out


# ---------------------------------------------------------------------------
# the QKV bias, and the master trees
# ---------------------------------------------------------------------------

def test_qkv_bias_carried_into_wqkv(qwen_master):
    """The port's own quantize_params keeps the QKV bias as the
    reference's does: ``attn.wqkv.b`` bitwise ``concat(bq, bk, bv)``."""
    cfg = get_config("qwen1.5-32b-reduced")
    master = jax.tree.map(np.asarray, qwen_master)
    want = _flat(jax.tree.map(np.asarray, jquantize(JQWEN, qwen_master)))
    got = _flat(quantize_params(cfg, from_numpy_tree(master, "cpu")))
    assert set(got) == set(want)
    for path, leaf in want.items():
        if "scale" in jax.tree_util.keystr(path):
            np.testing.assert_allclose(got[path].numpy(), leaf, rtol=1e-6,
                                       atol=0, err_msg=str(path))
        else:
            assert np.array_equal(got[path].numpy(), leaf), path
    wqkv = quantize_params(cfg, from_numpy_tree(master, "cpu"))[
        "layers"]["attn"]["wqkv"]
    attn = master["layers"]["attn"]
    bias = np.concatenate([attn[n]["b"] for n in ("wq", "wk", "wv")], -1)
    assert bias.any()
    assert np.array_equal(wqkv["b"].numpy(), bias)
    assert wqkv["b"].shape == (cfg.n_layers, cfg.q_dim + 2 * cfg.kv_dim)


@pytest.mark.parametrize("name", sorted(JCFGS))
def test_master_tree_matches_reference(name):
    """The port's seeded master tree has the reference's paths, shapes and
    dtypes: zero ``wq/wk/wv.b`` for qkv_bias, LayerNorm ``{g, b}``."""
    cfg = get_config(name)
    ref, _ = jinit(JCFGS[name], jax.random.PRNGKey(0))
    ours = _flat(init_params(cfg, 7, "cpu"))
    ref = _flat(ref)
    assert set(ours) == set(ref)
    for path, leaf in ref.items():
        assert ours[path].shape == leaf.shape, path
        assert str(ours[path].dtype).split(".")[-1] == str(leaf.dtype), path
        if jax.tree_util.keystr(path).endswith("['b']"):
            assert not ours[path].any(), path
    if cfg.qkv_bias:
        assert "b" in init_params(cfg, 7, "cpu")["layers"]["attn"]["wk"]


@pytest.mark.parametrize("shape,center", [((3, 5, 96), 0.0),
                                          ((7, 2048), 3.0),
                                          ((1, 1, 24), -50.0)])
def test_norm_apply_layernorm_matches_reference(shape, center):
    rng = np.random.default_rng(int(np.prod(shape)))
    x = (center + rng.standard_normal(shape) * rng.uniform(0.1, 8.0)).astype(
        np.float32)
    x[..., 0] *= 40.0                                  # an outlier column
    d = shape[-1]
    p = {"g": (1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
         "b": (0.02 * rng.standard_normal(d)).astype(np.float32)}
    want = np.asarray(jnorm_apply(jax.tree.map(jnp.asarray, p),
                                  jnp.asarray(x), "layernorm"))
    got = norm_apply({k: torch.from_numpy(v) for k, v in p.items()},
                     torch.from_numpy(x), "layernorm")
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # the population variance: the unbiased one is another function
    xt = torch.from_numpy(x)
    unbiased = ((xt - xt.mean(-1, keepdim=True))
                * torch.rsqrt(xt.var(-1, keepdim=True) + 1e-6)
                * torch.from_numpy(p["g"]) + torch.from_numpy(p["b"]))
    assert not np.allclose(unbiased.numpy(), want, rtol=1e-6, atol=1e-6)


def test_layernorm_rows_do_not_depend_on_each_other():
    """A row's LayerNorm is the same alone and among others, bitwise (what
    keeps chunked prefill bitwise whole-prompt prefill)."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((37, 96)).astype(np.float32))
    p = {"g": torch.ones(96), "b": torch.zeros(96)}
    whole = norm_apply(p, x, "layernorm")
    for i in (0, 17, 36):
        assert torch.equal(norm_apply(p, x[i:i + 1], "layernorm")[0],
                           whole[i])


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _prompts(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, (n,)).astype(np.int32) for n in lens]


@pytest.mark.parametrize("use_lop", [True, False], ids=["lop", "no-lop"])
@pytest.mark.parametrize("name", sorted(JCFGS))
def test_scheduler_matches_reference_lockstep(weights, name, use_lop):
    """2 requests of 40 tokens (two chunks each) on 2 slots, chunked
    prefill, greedy: each request's tokens equal the reference's lockstep
    on the same weights (one prompt length: one compile of the reference's
    prefill), and the port's own lockstep."""
    jqp, tqp = weights[name]
    cfg = get_config(name)
    eng = PooledEngine(cfg, tqp, max_len=MAX_LEN, use_lop=use_lop,
                       device="cpu")
    prompts = _prompts(cfg, [40, 40], 4)
    sched = Scheduler(eng, n_slots=2, check_invariants=True)
    assert sched.chunked
    for rid, p in enumerate(prompts):
        sched.submit(GenerateRequest(rid=rid, prompt=p, max_new_tokens=6))
    got = {r.rid: r.tokens for r in sched.run_to_completion()}
    for rid, p in enumerate(prompts):
        want = jlockstep(JCFGS[name], jqp, p, 6, max_len=MAX_LEN,
                         use_lop=use_lop)
        assert got[rid] == want, (rid, got[rid], want)
        assert got[rid] == lockstep_generate(eng, p, 6), rid
