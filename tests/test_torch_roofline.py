"""``repro_torch/analysis/roofline.py`` against the reference's
``repro/analysis/roofline.py``: the same functions of the same trees,
configs and cells, with the H100's published limits in place of the
TPU's.

The parameter counts run on the reduced bitnet-3b, granite-moe and
mixtral trees — the master tree of ``init_params`` and the quantized
serving tree — converted to the port's trees of torch tensors (shapes and
dtypes carried over onto the ``meta`` device, which holds no data: a
count reads shapes alone). The roofline terms pick their dominant term by
the port's constants: a cell between the two cards' ridge points is
compute-bound on the TPU and memory-bound on the H100.
"""
import jax
import numpy as np
import pytest
import torch

from repro.analysis import roofline as jroof
from repro.configs import base as jbase
from repro.configs.bitnet_3b import REDUCED as JBITNET
from repro.configs.granite_moe_1b_a400m import REDUCED as JGRANITE
from repro.configs.mixtral_8x22b import REDUCED as JMIXTRAL
from repro.models.transformer import init_params
from repro.serving.quantize import quantize_params
from repro_torch.analysis import roofline
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES, SMOKE_SHAPES
from repro_torch.tree_util import flatten_with_path, tree_map

torch.set_num_threads(1)

JCFGS = {c.name: c for c in (JBITNET, JGRANITE, JMIXTRAL)}


def _shapes(jcfg, serving: bool):
    """The reference's tree as ShapeDtypeStructs (no weights drawn)."""
    def build(key):
        params = init_params(jcfg, key)[0]
        return quantize_params(jcfg, params) if serving else params
    return jax.eval_shape(build, jax.random.PRNGKey(0))


def _to_port(tree):
    """The reference's tree → the port's: a torch tensor of each leaf's
    shape and dtype on the meta device."""
    return tree_map(lambda x: torch.empty(
        x.shape, dtype=torch.from_numpy(np.empty(0, x.dtype)).dtype,
        device="meta"), tree)


@pytest.mark.parametrize("serving", [False, True], ids=["master", "serving"])
@pytest.mark.parametrize("name", list(JCFGS))
def test_counts_match_the_reference(name, serving):
    jcfg, cfg = JCFGS[name], get_config(name)
    jtree = _shapes(jcfg, serving)
    tree = _to_port(jtree)
    assert [p for p, _ in flatten_with_path(tree)] == [
        jax.tree_util.keystr(p)
        for p, _ in jax.tree_util.tree_flatten_with_path(jtree)[0]]
    n = roofline.count_params(tree)
    assert n == jroof.count_params(jtree)
    active = roofline.active_params(cfg, n, tree)
    assert active == jroof.active_params(jcfg, n, jtree)
    assert roofline.active_params(cfg, n) == n
    if cfg.n_experts:
        assert active < n
    else:
        assert active == n


@pytest.mark.parametrize("shapes", [SHAPES, SMOKE_SHAPES],
                         ids=["full", "smoke"])
def test_model_flops_match_for_every_cell(shapes):
    jshapes = jbase.SHAPES if shapes is SHAPES else jbase.SMOKE_SHAPES
    assert list(shapes) == list(jshapes)
    jcfgs = {**jbase.all_configs(), **JCFGS}        # every arch, 3 reduced
    assert len(jcfgs) == 14
    for name, jcfg in jcfgs.items():
        cfg = get_config(name)
        for key, shape in shapes.items():
            js = jshapes[key]
            assert (shape.name, shape.seq_len, shape.global_batch,
                    shape.kind) == (js.name, js.seq_len, js.global_batch,
                                    js.kind)
            want = jroof.model_flops(jcfg, js, 10**9, 10**8)
            assert roofline.model_flops(cfg, shape, 10**9, 10**8) == want


def test_arithmetic_intensity_and_balance():
    for flops, nbytes in ((2e12, 1e9), (7.0, 0.0), (3.0, 4.0)):
        assert roofline.arithmetic_intensity(flops, nbytes) == \
            jroof.arithmetic_intensity(flops, nbytes)
    assert roofline.machine_balance() == 989e12 / 3.35e12
    assert roofline.machine_balance(int8=True) == 1979e12 / 3.35e12


def test_roofline_terms_pick_the_dominant_term_by_the_cards_limits():
    # intensity 270 op/B: above the TPU's ridge (~241), below the H100's
    # (~295)
    cost, coll = {"flops": 270e9, "bytes accessed": 1e9}, {"total": 0.0}
    assert jroof.roofline_terms(cost, coll)["dominant"] == "compute_s"
    t = roofline.roofline_terms(cost, coll)
    assert t["dominant"] == "memory_s"
    assert t["bound_s"] == t["memory_s"] == 1e9 / 3.35e12
    assert t["compute_s"] == 270e9 / 989e12
    assert t["compute_s_int8"] == 270e9 / 1979e12
    assert set(t) == set(jroof.roofline_terms(cost, coll))
    t = roofline.roofline_terms(cost, {"total": 1e9},
                                model_flops_per_chip=135e9)
    assert t["dominant"] == "collective_s"
    assert t["collective_s"] == 1e9 / 450e9
    assert t["useful_fraction"] == 0.5
    assert t["roofline_fraction"] == 135e9 / t["bound_s"] / 989e12
    assert set(t) == set(jroof.roofline_terms(
        cost, {"total": 1e9}, model_flops_per_chip=135e9))


def test_shared_memory_and_residency():
    assert roofline.smem_budget() == 232448
    # the decode kernels' two-stage CTA: eight an SM (PERF.md §6)
    assert roofline.resident_ctas_per_sm(128, 27040) == 8
    assert roofline.resident_ctas_per_sm(128, 94208) == 2
    assert roofline.resident_ctas_per_sm(1024, 0) == 2
    assert roofline.resident_ctas_per_sm(128, 232449) == 0
    # registers: 94 a thread → 3072 a warp → 5 CTAs of 4 warps; 128 → 4
    assert roofline.resident_ctas_per_sm(128, 29696, 94) == 5
    assert roofline.resident_ctas_per_sm(128, 29696, 128) == 4
    assert roofline.resident_ctas_per_sm(128, 29696, 256) == 0
