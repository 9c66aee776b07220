"""The port's core numerics held bitwise against the JAX reference.

Inputs come from numpy and go to both packages; integer stages must match
bit for bit. Also: the weight converter round-trips, no module of the
port imports JAX or the reference, and entry points refuse to fall back to
the CPU on their own.
"""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lop as jlop
from repro.core import quantization as jquant
from repro.core import ternary as jtern
from repro_torch.core import lop as tlop
from repro_torch.core import quantization as tquant
from repro_torch.core import ternary as ttern

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape,scale", [((7, 100), 3.0), ((3, 5, 32), 1e-7),
                                         ((4, 8640), 50.0)])
def test_quantize_bitwise(shape, scale):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    x[0, ..., :3] = 0.0                        # an all-but-zero edge
    j = jquant.quantize(jnp.asarray(x))
    t = tquant.quantize(_t(x))
    np.testing.assert_array_equal(t.values.numpy(), np.asarray(j.values))
    np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))


def test_quantize_half_to_even():
    # x / scale lands exactly on .5 → both round to the even neighbour
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5]], np.float32)
    j = jquant.quantize(jnp.asarray(x))
    t = tquant.quantize(_t(x))
    np.testing.assert_array_equal(t.values.numpy(), np.asarray(j.values))
    assert t.values.tolist() == [[127, 0, 2, 2, 0, -2]]


def test_ternary_pack_unpack_bitwise():
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((64, 24)) * 0.1).astype(np.float32)
    wt_j, g_j = jtern.ternary_quantize(jnp.asarray(w))
    wt_t, g_t = ttern.ternary_quantize(_t(w))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j).reshape(()),
                               rtol=1e-6)
    wt = np.asarray(wt_j)
    np.testing.assert_array_equal(
        torch.round(_t(w) / torch.tensor(np.asarray(g_j).reshape(())))
        .clamp(-1, 1).to(torch.int8).numpy(), wt)
    packed_j = np.asarray(jtern.pack_ternary(jnp.asarray(wt)))
    packed_t = ttern.pack_ternary(_t(wt))
    np.testing.assert_array_equal(packed_t.numpy(), packed_j)
    np.testing.assert_array_equal(
        ttern.unpack_ternary(packed_t, 64).numpy(),
        np.asarray(jtern.unpack_ternary(jnp.asarray(packed_j), 64)))
    # codes 0 and 3 both decode to 0
    odd = np.array([[0b11_10_01_00]], np.uint8)
    assert ttern.unpack_ternary(_t(odd), 4)[:, 0].tolist() == [0, 1, -1, 0]


def test_lop_features_bitwise():
    x = np.arange(-127, 128, dtype=np.int8).reshape(5, 51)
    for fn in ("leading_one", "pot", "lop_features"):
        np.testing.assert_array_equal(
            getattr(tlop, fn)(_t(x)).numpy(),
            np.asarray(getattr(jlop, fn)(jnp.asarray(x))), err_msg=fn)
    feat = np.asarray(jlop.lop_features(jnp.asarray(x)))[:, :50]
    packed = tlop.pack_features(_t(feat))
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jlop.pack_features(jnp.asarray(feat))))
    np.testing.assert_array_equal(tlop.unpack_features(packed).numpy(), feat)
    np.testing.assert_array_equal(
        tlop.features_to_pot(_t(feat)).numpy(),
        np.asarray(jlop.features_to_pot(jnp.asarray(feat))))


def _rank_cases():
    rng = np.random.default_rng(2)
    rows = [rng.standard_normal(13).astype(np.float32) * 1e4,
            np.round(rng.standard_normal(13) * 3).astype(np.float32),  # ties
            np.full(13, -np.inf, np.float32),                          # none
            np.zeros(13, np.float32),                                  # flat
            np.where(rng.random(13) < 0.5, -np.inf,
                     rng.integers(-5000, 5000, 13)).astype(np.float32)]
    return np.stack(rows)


@pytest.mark.parametrize("k", [1, 2, 5, 13])
def test_comparison_free_rank_bitwise(k):
    s = _rank_cases()
    np.testing.assert_array_equal(
        tlop.comparison_free_rank(_t(s), k).numpy(),
        np.asarray(jlop.comparison_free_rank(jnp.asarray(s), k)))
    for row in s:
        idx_j, gate_j = jlop.comparison_free_topk(jnp.asarray(row), k)
        idx_t, gate_t = tlop.comparison_free_topk(_t(row), k)
        np.testing.assert_array_equal(gate_t.numpy(), np.asarray(gate_j))
        np.testing.assert_array_equal(idx_t.numpy()[gate_t.numpy()],
                                      np.asarray(idx_j)[np.asarray(gate_j)])


def test_config_fields_match_reference():
    from repro.configs.bitnet_3b import CONFIG, REDUCED
    from repro_torch.configs import get_config
    for ref in (CONFIG, REDUCED):
        port = get_config(ref.name)
        for field in ref.__dataclass_fields__:
            assert getattr(port, field) == getattr(ref, field), field
        assert (port.hd, port.q_dim, port.kv_dim, port.vocab_padded) == \
            (ref.hd, ref.q_dim, ref.kv_dim, ref.vocab_padded)


def test_convert_round_trip_bitwise():
    from repro.configs.bitnet_3b import REDUCED
    from repro.models.transformer import init_params
    from repro.serving.quantize import quantize_params
    from repro_torch.convert import from_numpy_tree

    params, _ = init_params(REDUCED, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, quantize_params(REDUCED, params))
    port = from_numpy_tree(tree, "cpu")
    back = jax.tree.map(lambda t: t.numpy(), port)
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        other = flat_b[path]
        assert other.dtype == leaf.dtype and other.shape == leaf.shape, path
        np.testing.assert_array_equal(other.view(np.uint8),
                                      leaf.view(np.uint8), err_msg=str(path))


def _port_sources():
    yield from sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    yield ROOT / "chip_smoke.py"


@pytest.mark.parametrize("path", list(_port_sources()),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_or_reference(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_entry_point_without_card_raises(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.serving.api import PooledEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PooledEngine.from_seed(get_config("bitnet-3b-reduced"), seed=0,
                               max_len=31)
