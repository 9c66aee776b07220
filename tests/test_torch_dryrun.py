"""The port's dry-run (``repro_torch.launch.dryrun``: every cell traced on
the ``meta`` device) held against the reference's ``launch/dryrun.py``:

  * the abstract trees: the master and served trees' leaf paths, shapes
    and dtypes equal ``jax.eval_shape`` of the reference's ``init_params``
    and ``quantize_params`` for every reduced config, and so do
    ``count_params`` and ``active_params``;
  * the rules: ``shape_applicable`` (and its reason), ``decode_sharding``,
    ``_variant_cfg`` and ``_depth_units`` over every config × ``SHAPES`` ×
    both production meshes;
  * per-rank shard shapes of the params, the served tree under
    ``qparam_pspecs`` and the decode cache on ``pod16x16`` and
    ``pod2x16x16``;
  * the differential self-check (``base + L·per_layer`` equals the
    full-depth trace exactly) for one reduced config of each family;
  * the sweep: every reduced config × ``SMOKE_SHAPES`` × both meshes ends
    ``ok`` or in the reference's ``long_500k`` skip;
  * the CLI's JSON: the reference's keys plus ``fits`` and ``layout``,
    the roofline under the card's constants and no TPU figure.

``import repro.launch.dryrun`` sets ``XLA_FLAGS`` at import (512 host
devices), so the reference's side runs once in a child process, as
``tests/test_dryrun.py`` runs it, and prints what the tests compare.
"""
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import shape_applicable as jshape_applicable
from repro_torch.analysis.roofline import (HBM_BW, NVLINK_BW,
                                           PEAK_FLOPS_BF16, active_params,
                                           count_params)
from repro_torch.configs import all_configs, get_config
from repro_torch.configs.base import SHAPES, SMOKE_SHAPES, shape_applicable
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.serving.cache import cache_pspecs, init_cache
from repro_torch.serving.quantize import quantize_params
from repro_torch.tree_util import flatten_with_path

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REDUCED = sorted(n for n in all_configs() if n.endswith("-reduced"))
MESHES = (False, True)

CHILD = r"""
import importlib, json, sys
import jax
from jax.sharding import NamedSharding
from repro.analysis.roofline import active_params, count_params
from repro.configs.base import SHAPES, SMOKE_SHAPES
from repro.launch import dryrun as D
from repro.launch.mesh import make_production_mesh
from repro.serving.cache import cache_pspecs, init_cache
from repro.serving.quantize import quantize_params

MODULES = ("bitnet_3b", "granite_moe_1b_a400m", "jamba_1_5_large_398b",
           "llava_next_34b", "mistral_nemo_12b", "mixtral_8x22b",
           "qwen1_5_110b", "qwen1_5_32b", "rwkv6_1_6b", "stablelm_1_6b",
           "whisper_small")
cfgs = {}
for m in MODULES:
    mod = importlib.import_module(f"repro.configs.{m}")
    cfgs[mod.CONFIG.name] = mod.CONFIG
    cfgs[mod.REDUCED.name] = mod.REDUCED
meshes = {mp: make_production_mesh(multi_pod=mp) for mp in (0, 1)}


def shapes_of(tree):
    return {jax.tree_util.keystr(p): [list(x.shape), str(x.dtype)]
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def shards(mesh, specs, sds):
    sh = jax.tree_util.tree_leaves(
        D._shardings(mesh, specs, sds),
        is_leaf=lambda x: isinstance(x, NamedSharding))
    flat = jax.tree_util.tree_flatten_with_path(sds)[0]
    return {jax.tree_util.keystr(p): list(s.shard_shape(x.shape))
            for (p, x), s in zip(flat, sh)}


out = {"rules": {}, "trees": {}}
for name, cfg in cfgs.items():
    for sn, shape in SHAPES.items():
        for mp, mesh in meshes.items():
            sp, align, bax = D.decode_sharding(cfg, mesh, shape.global_batch)
            out["rules"][f"{name}|{sn}|{mp}"] = [list(sp), align, bax]
    out["rules"][f"{name}|depth"] = [D._depth_units(cfg)] + [
        [D._variant_cfg(cfg, u).n_layers,
         D._variant_cfg(cfg, u).n_encoder_layers] for u in (1, 2)]
for name, cfg in cfgs.items():
    if not name.endswith("-reduced"):
        continue
    p_sds, pspecs = D.abstract_params(cfg)
    qp_sds = jax.eval_shape(lambda p: quantize_params(cfg, p), p_sds)
    qspecs = D.qparam_pspecs(pspecs, qp_sds)
    n = count_params(p_sds)
    rec = {"params": shapes_of(p_sds), "qparams": shapes_of(qp_sds),
           "n_params": n, "n_active": active_params(cfg, n, p_sds)}
    for mp, mesh in meshes.items():
        rec[f"params|{mp}"] = shards(mesh, pspecs, p_sds)
        rec[f"qparams|{mp}"] = shards(mesh, qspecs, qp_sds)
        for sn, shape in (("decode_32k", SHAPES["decode_32k"]),
                          ("long_500k", SMOKE_SHAPES["long_500k"])):
            sp, align, bax = D.decode_sharding(cfg, mesh,
                                               shape.global_batch)
            cache = jax.eval_shape(lambda: init_cache(
                cfg, shape.global_batch, shape.seq_len, align=align))
            rec[f"cache_{sn}|{mp}"] = shards(
                mesh, cache_pspecs(cfg, cache, batch_axes=bax, seq_axes=sp),
                cache)
    out["trees"][name] = rec
json.dump(out, sys.stdout)
"""


@pytest.fixture(scope="module")
def ref():
    """The reference's trees, shard shapes and rules, from one child."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu", TF_CPP_MIN_LOG_LEVEL="2")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", CHILD], capture_output=True,
                         text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout)


def _shapes(tree) -> dict:
    return {p: [list(x.shape), str(x.dtype).removeprefix("torch.")]
            for p, x in flatten_with_path(tree)}


@pytest.mark.parametrize("name", REDUCED)
def test_abstract_trees_match_reference(ref, name):
    cfg = get_config(name)
    params, _ = D.abstract_params(cfg)
    want = ref["trees"][name]
    assert _shapes(params) == want["params"]
    qp = quantize_params(cfg, params)
    assert _shapes(qp) == want["qparams"]
    n = count_params(params)
    assert n == want["n_params"]
    assert active_params(cfg, n, params) == want["n_active"]
    assert all(x.device.type == "meta" for _, x in flatten_with_path(qp))


def test_rules_match_reference(ref):
    meshes = {mp: make_production_mesh(multi_pod=mp) for mp in MESHES}
    for name, cfg in all_configs().items():
        for sn, shape in SHAPES.items():
            got = shape_applicable(cfg, shape)
            assert got == jshape_applicable(cfg, JSHAPES[sn]), (name, sn)
            for mp, mesh in meshes.items():
                sp, align, bax = D.decode_sharding(cfg, mesh,
                                                   shape.global_batch)
                assert [list(sp), align, bax] == \
                    ref["rules"][f"{name}|{sn}|{int(mp)}"], (name, sn, mp)
        assert [D._depth_units(cfg)] + [
            [D._variant_cfg(cfg, u).n_layers,
             D._variant_cfg(cfg, u).n_encoder_layers] for u in (1, 2)] == \
            ref["rules"][f"{name}|depth"], name


@pytest.mark.parametrize("name", REDUCED)
def test_shard_shapes_match_reference(ref, name):
    cfg = get_config(name)
    params, pspecs = D.abstract_params(cfg)
    qp = quantize_params(cfg, params)
    qspecs = D.qparam_pspecs(pspecs, qp)
    want = ref["trees"][name]
    for mp in MESHES:
        mesh = make_production_mesh(multi_pod=mp)
        assert _leaf_shards(mesh, pspecs, params) == \
            want[f"params|{int(mp)}"]
        assert _leaf_shards(mesh, qspecs, qp) == want[f"qparams|{int(mp)}"]
        for sn, shape in (("decode_32k", SHAPES["decode_32k"]),
                          ("long_500k", SMOKE_SHAPES["long_500k"])):
            sp, align, bax = D.decode_sharding(cfg, mesh,
                                               shape.global_batch)
            cache = init_cache(cfg, shape.global_batch, shape.seq_len,
                               "meta", align=align)
            specs = cache_pspecs(cfg, cache, batch_axes=bax, seq_axes=sp)
            assert _leaf_shards(mesh, specs, cache) == \
                want[f"cache_{sn}|{int(mp)}"], (sn, mp)


def _leaf_shards(mesh, specs, tree) -> dict:
    dims = D._shardings(mesh, specs, tree)
    out = {}

    def walk(node, dnode, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], dnode[k], f"{prefix}[{k!r}]")
        else:
            out[prefix] = list(D.shard_shape(node.shape, dnode, mesh))
    walk(tree, dims, "")
    return out


# one reduced config a family, each at a cell of its own kind
FAMILY_CELLS = (("bitnet-3b-reduced", "train_4k"),
                ("granite-moe-1b-a400m-reduced", "decode_32k"),
                ("whisper-small-reduced", "prefill_32k"),
                ("rwkv6-1.6b-reduced", "prefill_32k"),
                ("jamba-1.5-large-398b-reduced", "decode_32k"),
                ("llava-next-34b-reduced", "prefill_32k"))


@pytest.mark.parametrize("name,shape", FAMILY_CELLS)
def test_differential_equals_full_trace(name, shape):
    """base + L·per_layer equals the full-depth trace for flops, bytes,
    hbm and coll exactly: the trace counts every layer."""
    r = D.run_cell(name, shape, shape=SMOKE_SHAPES[shape], n_micro=1,
                   verbose=False)
    assert r["status"] == "ok"
    diff = r["differential"]
    assert diff["self_check"] == {"flops": 0, "bytes": 0, "hbm": 0,
                                  "coll": 0}
    ell = D._depth_units(get_config(name))
    for k in ("flops", "bytes", "hbm", "coll"):
        assert diff[k] == diff["base"][k] + ell * diff["per_layer"][k]
    assert diff["per_layer"]["flops"] > 0
    if shape == "train_4k":
        assert diff["per_layer"]["coll"] > 0
        assert r["raw_scan_cost"]["kernels"] == {}


@pytest.mark.parametrize("name", REDUCED)
def test_sweep_every_smoke_cell(name):
    """Every reduced config × SMOKE_SHAPES × both meshes ends ``ok`` or
    in the reference's documented long_500k skip."""
    cfg = get_config(name)
    for sn, shape in SMOKE_SHAPES.items():
        for mp in MESHES:
            r = D.run_cell(name, sn, multi_pod=mp, shape=shape, n_micro=1,
                           differential=False, verbose=False)
            ok, reason = shape_applicable(cfg, shape)
            if not ok:
                assert r == {"arch": name, "shape": sn,
                             "mesh": "pod2x16x16" if mp else "pod16x16",
                             "kind": shape.kind, "status": "skip",
                             "reason": reason}
                continue
            assert r["status"] == "ok", (sn, mp)
            assert r["chips"] == (512 if mp else 256)
            mem = r["memory"]
            assert mem["peak_estimate_bytes"] == (
                mem["argument_bytes"] + mem["output_bytes"]
                + mem["temp_bytes"] - mem["alias_bytes"])
            assert mem["temp_bytes"] >= 0 and r["fits"]
            kernels = r["raw_scan_cost"]["kernels"]
            if shape.kind == "train":
                assert kernels == {}
            else:
                assert kernels.get("fused_qlinear", 0) > 0


REF_KEYS = {"arch", "shape", "mesh", "kind", "status", "chips", "n_params",
            "n_active_params", "n_micro", "memory", "roofline",
            "raw_scan_cost", "differential"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
               "peak_estimate_bytes"}


def test_cli_writes_reference_keys(tmp_path):
    assert D.main(["--arch", "bitnet-3b-reduced", "--shape", "decode_32k",
                   "--out", str(tmp_path)]) == 0
    path = tmp_path / "bitnet-3b-reduced__decode_32k__sp.json"
    text = path.read_text()
    res = json.loads(text)
    assert set(res) == REF_KEYS | {"trace_s", "fits", "layout"}
    assert set(res["memory"]) == MEMORY_KEYS
    assert res["fits"] is True
    assert res["layout"]["cache"] == ["data", "model"]
    terms, diff = res["roofline"], res["differential"]
    assert terms["memory_s"] == diff["hbm"] / HBM_BW
    assert terms["compute_s"] == diff["flops"] / PEAK_FLOPS_BF16
    assert terms["collective_s"] == diff["coll"] / NVLINK_BW
    assert terms["memory_s_raw_upper"] == diff["bytes"] / HBM_BW
    assert res["raw_scan_cost"]["kernels"] == {
        "fused_decode_attention": 3, "fused_ffn": 3, "fused_qlinear": 6}
    # no TPU figure: not its HBM rate, peak, ICI rate or HBM size
    for src in ("launch/dryrun.py", "analysis/roofline.py",
                "analysis/op_trace.py"):
        body = open(os.path.join(REPO, "src/repro_torch", src)).read()
        for tpu in ("819e9", "197e12", "50e9", "16e9", "16 GB", "2**34"):
            assert not re.search(r"(?<![\w.])" + re.escape(tpu), body), \
                (src, tpu)
