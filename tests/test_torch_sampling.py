"""The port's sampler held against the reference's ``jax.random`` path.

  * threefry random bits and the uniform are bitwise JAX's
    (``jax_threefry_partitionable``), for several seeds, steps and widths;
  * the Gumbel noise agrees to rtol 1e-6 (plus 2.4e-7 absolute: the two
    libraries' f32 ``log`` may differ by one ulp at 1.0, which the outer
    log carries into values near 0);
  * ``sample_tokens`` gives JAX's tokens over a grid of greedy, T = 0.8,
    top-k ∈ {1, 20} and top-p ∈ {0.5, 0.95} lanes mixed in one batch;
  * greedy lanes are bitwise argmax, lanes are independent, one key gives
    one draw, and the filters restrict the support.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import sampling as jsamp
from repro_torch.serving import sampling as tsamp

torch.set_num_threads(1)

TINY = float(np.finfo(np.float32).tiny)


def _jkey(seed, step):
    return jax.random.fold_in(jax.random.PRNGKey(jnp.uint32(seed)),
                              jnp.uint32(step))


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1])
@pytest.mark.parametrize("step", [0, 1, 5])
@pytest.mark.parametrize("v", [512, 32000])
def test_random_bits_uniform_gumbel_match_jax(seed, step, v):
    jk = _jkey(seed, step)
    tk = tsamp.fold_in(tsamp.prng_key(seed), step)
    assert tk.tolist() == np.asarray(jk).astype(np.int64).tolist()
    want = np.asarray(jax.random.bits(jk, (v,), jnp.uint32)).astype(np.int64)
    assert np.array_equal(tsamp.random_bits(tk[None], v)[0].numpy(), want)
    u = np.asarray(jax.random.uniform(jk, (v,), jnp.float32, minval=TINY,
                                      maxval=1.0))
    assert np.array_equal(tsamp.uniform(tk[None], v, TINY, 1.0)[0].numpy(),
                          u)
    g = np.asarray(jax.random.gumbel(jk, (v,), jnp.float32, mode="low"))
    np.testing.assert_allclose(tsamp.gumbel(tk[None], v)[0].numpy(), g,
                               rtol=1e-6, atol=2.4e-7)


def test_lane_keys_match_jax():
    seeds = np.array([0, 7, 2 ** 31 - 1, -3, 5], np.int32)
    steps = np.array([0, 1, 5, 9, 2 ** 20], np.int32)
    want = np.asarray(jsamp.lane_keys(jnp.asarray(seeds),
                                      jnp.asarray(steps))).astype(np.int64)
    got = tsamp.lane_keys(torch.from_numpy(seeds), torch.from_numpy(steps))
    assert np.array_equal(got.numpy(), want)


# one batch of mixed lanes: (temperature, top_k, top_p)
LANES = [(0.0, 0, 1.0), (0.8, 0, 1.0), (0.8, 1, 1.0), (0.8, 20, 1.0),
         (0.8, 0, 0.5), (0.8, 0, 0.95), (0.8, 20, 0.95), (0.8, 1, 0.5)]


@pytest.mark.parametrize("v", [512, 32000])
@pytest.mark.parametrize("trial", range(3))
def test_sample_tokens_match_jax(v, trial):
    rng = np.random.default_rng(100 * trial + v)
    b = len(LANES)
    logits = (rng.standard_normal((b, v)) * 3).astype(np.float32)
    temps, tks, tps = (np.array(c, dt) for c, dt in
                       zip(zip(*LANES), (np.float32, np.int32, np.float32)))
    seeds = rng.integers(0, 2 ** 31 - 1, b).astype(np.int32)
    steps = rng.integers(0, 100, b).astype(np.int32)
    want = np.asarray(jsamp.sample_with_seed(*map(jnp.asarray, (
        logits, seeds, steps, temps, tks, tps))))
    got = tsamp.sample_with_seed(*map(torch.from_numpy, (
        logits, seeds, steps, temps, tks, tps)))
    assert got.dtype == torch.int32
    assert got.tolist() == want.tolist()


def test_greedy_lane_is_bitwise_argmax():
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((4, 40)).astype(np.float32))
    keys = tsamp.lane_keys(torch.arange(4), torch.zeros(4, dtype=torch.int32))
    toks = tsamp.sample_tokens(logits, keys, torch.zeros(4),
                               torch.zeros(4, dtype=torch.int32),
                               torch.ones(4))
    assert toks.tolist() == torch.argmax(logits, -1).tolist()


def test_lanes_are_independent():
    """A lane's token depends on its own logits, key and policy only."""
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((4, 300)).astype(np.float32)
    args = (torch.tensor([11, 12, 13, 14]), torch.tensor([3, 4, 5, 6]),
            torch.tensor([0.8, 0.8, 0.0, 1.3]),
            torch.tensor([20, 0, 0, 5], dtype=torch.int32),
            torch.tensor([0.95, 0.5, 1.0, 1.0]))
    base = tsamp.sample_with_seed(torch.from_numpy(logits), *args)
    other = logits.copy()
    other[[0, 2, 3]] = rng.standard_normal((3, 300)) * 5
    moved = tsamp.sample_with_seed(torch.from_numpy(other), *args)
    assert int(moved[1]) == int(base[1])


def test_same_key_same_draw_different_key_varies():
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(np.tile(rng.standard_normal((1, 64)),
                                      (128, 1)).astype(np.float32))
    temps, tks, tps = torch.ones(128), torch.zeros(128, dtype=torch.int32), \
        torch.ones(128)
    same = tsamp.lane_keys(torch.full((128,), 7), torch.full((128,), 3))
    a = tsamp.sample_tokens(logits, same, temps, tks, tps)
    assert (a == a[0]).all()
    varied = tsamp.lane_keys(torch.full((128,), 7), torch.arange(128))
    assert len(torch.unique(tsamp.sample_tokens(logits, varied, temps, tks,
                                                tps))) > 1


def test_top_k_and_top_p_restrict_support():
    n = 512
    row = np.zeros(32, np.float32)
    row[[4, 11, 27]] = [3.0, 2.5, 2.0]
    keys = tsamp.lane_keys(torch.zeros(n, dtype=torch.int32), torch.arange(n))
    toks = tsamp.sample_tokens(torch.from_numpy(np.tile(row, (n, 1))), keys,
                               torch.ones(n), torch.full((n,), 3,
                                                         dtype=torch.int32),
                               torch.ones(n))
    assert set(toks.tolist()) <= {4, 11, 27}
    assert (toks == 4).sum() > (toks == 27).sum()
    peak = np.zeros(16, np.float32)
    peak[5] = 8.0
    toks = tsamp.sample_tokens(torch.from_numpy(np.tile(peak, (n, 1))), keys,
                               torch.ones(n), torch.zeros(n,
                                                          dtype=torch.int32),
                               torch.full((n,), 0.5))
    assert (toks == 5).all()
