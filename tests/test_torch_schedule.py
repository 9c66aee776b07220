"""``repro_torch/core/schedule.py`` (the paper's head-level schedule,
§III-B, Fig. 9) against the reference's ``repro/core/schedule.py``: the
materialized and the streamed schedule and the softmax attention both use,
on the same seeded inputs, at groups 1, 2 and 4, within the reference
test's atol 1e-4 (``tests/test_schedule.py``). The largest gap observed
on the CPU is 4.2e-7 (streamed) and 2.1e-7 (materialized): the f32
products sum in another order (the reference's scan feeds XLA the
weights in group-major slices).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import schedule as jsched
from repro_torch.core import schedule

torch.set_num_threads(1)

B, S, D, H, HD = 2, 16, 64, 4, 16
ATOL = 1e-4


def _inputs(seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    ws = [(rng.standard_normal((D, H * HD)) * 0.1).astype(np.float32)
          for _ in range(3)]
    wo = (rng.standard_normal((H * HD, D)) * 0.1).astype(np.float32)
    return [x, *ws, wo]


def _both(fn, jfn, arrays, **kw):
    got = fn(*(torch.from_numpy(a) for a in arrays), **kw)
    want = jfn(*(jnp.asarray(a) for a in arrays), **kw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("causal", [True, False])
def test_softmax_attention_matches_reference(causal):
    rng = np.random.default_rng(7)
    qkv = [rng.standard_normal((B, S, H, HD)).astype(np.float32)
           for _ in range(3)]
    got, want = _both(schedule.standard_softmax_attention,
                      jsched.standard_softmax_attention, qkv, causal=causal)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_materialized_matches_reference():
    got, want = _both(
        lambda *a: schedule.materialized_mha(
            *a, n_heads=H, head_dim=HD,
            attn_fn=schedule.standard_softmax_attention),
        lambda *a: jsched.materialized_mha(
            *a, n_heads=H, head_dim=HD,
            attn_fn=jsched.standard_softmax_attention), _inputs(3))
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("group", [1, 2, 4])
def test_streamed_matches_reference_and_materialized(group):
    arrays = _inputs(3 + group)
    got, want = _both(
        lambda *a: schedule.streamed_mha(
            *a, n_heads=H, head_dim=HD,
            attn_fn=schedule.standard_softmax_attention, group=group),
        lambda *a: jsched.streamed_mha(
            *a, n_heads=H, head_dim=HD,
            attn_fn=jsched.standard_softmax_attention, group=group), arrays)
    np.testing.assert_allclose(got, want, atol=ATOL)
    whole = schedule.materialized_mha(
        *(torch.from_numpy(a) for a in arrays), n_heads=H, head_dim=HD,
        attn_fn=schedule.standard_softmax_attention).numpy()
    np.testing.assert_allclose(got, whole, atol=ATOL)


def test_streamed_rejects_a_group_that_does_not_divide_the_heads():
    with pytest.raises(ValueError, match="multiple of group"):
        schedule.streamed_mha(*(torch.from_numpy(a) for a in _inputs(0)),
                              n_heads=H, head_dim=HD,
                              attn_fn=schedule.standard_softmax_attention,
                              group=3)
