"""Multi-pod dry-run as a meta-device trace — the counterpart of the
reference's ``launch/dryrun.py``.

For each cell (architecture × input shape × production mesh) this builds
one rank's inputs on the ``meta`` device (shapes and dtypes, no storage),
runs that rank's program eagerly under
:class:`repro_torch.analysis.op_trace.OpTrace` on an abstract mesh
(:func:`repro_torch.launch.mesh.make_production_mesh`: one rank of 256
or 512, whose collectives move nothing and record their bytes), and
records::

    per-rank FLOPs, raw and fused-HBM bytes      — the roofline terms
    collective bytes by kind                     — the abstract mesh
    kernel launches by kernel and mode           — the kernel entries
    live bytes: arguments, outputs, temporaries  — does it fit one card

under the card's data-sheet limits (:mod:`repro_torch.analysis.roofline`).
The reference jits each cell on a 512-device host platform and reads
XLA's ``memory_analysis()`` / ``cost_analysis()`` and the HLO text; the
port lowers no program and reads no environment flag.

The port has no automatic partitioner, so each cell's per-rank program is
the port's own (``layout`` in the JSON names the axes):

* train: ``make_train_step(cfg, n_micro=, mesh=, dims=)`` — the masters
  and moments FSDP-cut under the reference's partition specs, the global
  batch in and the rank's data shard taken, each layer gathered in its
  remat, the compute repeated across ``model``;
* prefill: the rank's data shard of the batch through
  ``serving.engine.prefill`` with the whole served tree (replicated over
  ``model``), the capacity aligned as :func:`decode_sharding`'s
  ``align``, the cache then cut to the rank's ``sp`` (``model``) shard
  (``shard_cache``), as the reference's prefill cell lays it out;
* decode: ``serve_step(sp_axes=...)`` over the rank's cache shard with
  the whole served tree; ssm takes no SP (the reference's ``use_sp``).
  The reference's heads-over-``model`` TP of rwkv6 and Mamba comes from
  XLA's partitioner alone and is not ported: a recurrent state's ``tp``
  dims stay whole on the rank.

Usage (no card needed)::

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch mixtral-8x22b --shape decode_32k [--multi-pod] \\
        [--both-meshes] [--n-micro 1] [--no-differential] \\
        [--out experiments/dryrun_torch]

Exit code 0 = every cell traced (or is a documented skip).
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import sys
import time
import traceback

import torch

from repro_torch.analysis.op_trace import (OpTrace, collective_bytes,
                                           hbm_bytes)
from repro_torch.analysis.roofline import (HBM_BW, HBM_BYTES, active_params,
                                           count_params, model_flops,
                                           roofline_terms)
from repro_torch.configs.base import (SHAPES, ShapeConfig, all_configs,
                                      get_config, input_specs,
                                      shape_applicable, text_len)
from repro_torch.distributed.partitioning import (dp_axes, leaf_dims,
                                                  shard_of, use_mesh)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.transformer import init_params, param_specs
from repro_torch.serving.cache import cache_pspecs, init_cache, round_up
from repro_torch.serving.engine import prefill, serve_step, shard_cache
from repro_torch.serving.quantize import quantize_params
from repro_torch.training.optimizer import adamw_init
from repro_torch.training.train import make_train_step, shard_dims, shard_tree

META = torch.device("meta")


# ---------------------------------------------------------------------------
# Abstract (allocation-free) param/state construction
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=4)
def abstract_params(cfg):
    """(meta master tree, logical pspecs) without allocating: the seeded
    draw on ``meta`` (nothing drawn) and the reference's partition specs
    (:func:`repro_torch.models.transformer.param_specs`). Cached by
    config: a sweep's cells of one config share it, and nothing writes a
    meta tree."""
    params = init_params(cfg, 0, device=META)
    return params, param_specs(cfg, params)


@functools.lru_cache(maxsize=4)
def _served_tree(cfg):
    """The served (quantized) tree of :func:`abstract_params`, cached."""
    return quantize_params(cfg, abstract_params(cfg)[0])


def qparam_pspecs(pspecs, qparams):
    """Map original param pspecs onto the quantized (packed/fused) tree.

    Fused serving nodes inherit the spec of a representative source
    projection: ``wqkv`` ← ``wq``, ``wkv`` ← ``wk``, the whole-FFN gu/down
    streams ← ``w_up``/``w_down``. Scales replicate; segment sizes that no
    longer divide the mesh axis fall back to replicated via
    ``_shardings``.
    """
    def wspec(sp):
        return sp["w"] if isinstance(sp, dict) and "w" in sp else sp

    def walk(sp, qp):
        if isinstance(qp, dict) and "packed" in qp:
            out = {"packed": wspec(sp),
                   "scale": (None,) * qp["scale"].ndim}
            if "b" in qp:
                out["b"] = sp["b"] if isinstance(sp, dict) and "b" in sp \
                    else (None,) * qp["b"].ndim
            return out
        if isinstance(qp, dict) and "gu_packed" in qp:
            out = {"gu_packed": wspec(sp["w_up"]),
                   "gu_scale": (None,) * qp["gu_scale"].ndim,
                   "down_packed": wspec(sp["w_down"]),
                   "down_scale": (None,) * qp["down_scale"].ndim}
            for k, v in qp.items():
                if k not in out:
                    out[k] = walk(sp[k], v)
            return out
        if isinstance(qp, dict):
            src = {"wqkv": "wq", "wkv": "wk"}
            return {k: walk(sp[src.get(k, k)], v) for k, v in qp.items()}
        return sp

    return walk(pspecs, qparams)


def _axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, str):
        return int(mesh.shape[entry])
    return math.prod(int(mesh.shape[a]) for a in entry)


def _shardings(mesh, logical_tree, tree):
    """Logical trees → each leaf's cut dims on ``mesh`` (for each dim the
    mesh axes it is cut over, or None): axes whose size does not divide
    the dim are dropped to replicated (keeps reduced/smoke configs and odd
    head counts legal), :func:`repro_torch.distributed.partitioning.
    leaf_dims`."""
    if isinstance(tree, dict):
        return {k: _shardings(mesh, logical_tree[k], v)
                for k, v in tree.items()}
    return leaf_dims(logical_tree, tree.shape, mesh)


def shard_shape(shape, dims, mesh) -> tuple:
    """The shape of one rank's shard of a leaf of ``shape`` cut as
    ``dims``."""
    return tuple(n // _axis_size(mesh, axes) for n, axes in
                 zip(shape, dims))


def _cut(tree, dims, mesh):
    """The rank's shard of every leaf of the meta ``tree``."""
    if isinstance(tree, dict):
        return {k: _cut(v, dims[k], mesh) for k, v in tree.items()}
    return shard_of(tree, dims, mesh.coords(), mesh)


def _rank_cache_specs(spec_tree, batch_ax):
    """The decode cell's cache specs as the port's rank holds the cache:
    ``tp`` dropped (a recurrent state whole on every rank: no
    heads-over-model TP) and the per-lane vectors cut over the batch
    axes with the pages (the reference keeps them whole in its global
    view)."""
    out = {}
    for k, v in spec_tree.items():
        if isinstance(v, dict):
            out[k] = _rank_cache_specs(v, batch_ax)
        elif k in ("lengths", "cross_len"):
            out[k] = (batch_ax,)
        else:
            out[k] = tuple(None if a == "tp" else a for a in v)
    return out


def _dp(mesh) -> tuple:
    return tuple(a for a in dp_axes(mesh) if a in mesh.axis_names)


def _local_batch(mesh, batch: int) -> int:
    """The rank's share of a global batch: a data shard, or the whole
    batch where the data axes do not divide it."""
    n = mesh.size(_dp(mesh))
    return batch if batch % n else batch // n


# ---------------------------------------------------------------------------
# Cell builders
# ---------------------------------------------------------------------------

def build_train_cell(cfg, shape, mesh, *, n_micro: int = 1):
    """→ (fn, args, master tree, layout): ``fn(*args)`` is one rank's
    sharded training step."""
    p_full, _ = abstract_params(cfg)
    dims = shard_dims(cfg, p_full, mesh)
    params = shard_tree(p_full, dims, mesh)
    opt = adamw_init(params)
    batch = input_specs(cfg, shape)
    step = make_train_step(cfg, n_micro=n_micro, mesh=mesh, dims=dims)
    dp = list(_dp(mesh))
    layout = {"batch": dp, "params": dp + ["model"], "cache": [],
              "compute": dp, "repeated": ["model"]}
    return step, (params, opt, batch), p_full, layout


def build_prefill_cell(cfg, shape, mesh):
    """→ (fn, args, master tree, layout): one rank's prefill of its data
    shard with the whole served tree, its cache cut to the ``sp`` shard."""
    p_full, _ = abstract_params(cfg)
    qp = _served_tree(cfg)
    _, align, _ = decode_sharding(cfg, mesh, shape.global_batch)
    local = ShapeConfig(shape.name, shape.seq_len,
                        _local_batch(mesh, shape.global_batch), shape.kind)
    batch = input_specs(cfg, local)
    s_total = text_len(cfg, shape.seq_len, "prefill") + (
        cfg.n_img_tokens if cfg.family == "vlm" else 0)
    max_len = round_up(s_total + 1, align) - 1

    def fn_prefill(qp, batch):
        logits, cache = prefill(cfg, qp, batch["tokens"], max_len=max_len,
                                frames=batch.get("frames"),
                                patches=batch.get("patches"))
        # the reference's prefill cache: its token axis over ``sp``
        return logits, shard_cache(cache, ("model",))

    dp = list(_dp(mesh)) if local.global_batch != shape.global_batch else []
    layout = {"batch": dp, "params": [], "cache": dp + ["model"],
              "compute": dp, "repeated": [a for a in mesh.axis_names
                                          if a not in dp]}
    return fn_prefill, (qp, batch), p_full, layout


def decode_sharding(cfg, mesh, batch: int):
    """(sp_axes, capacity alignment, batch logical axis) for decode cells."""
    dp = math.prod(int(mesh.shape[a]) for a in dp_axes(mesh))
    if batch % dp == 0 and batch >= dp:
        sp_axes = ("model",)
        batch_ax = "dp"
    else:
        # batch too small to shard (long_500k B=1): fold data into SP
        sp_axes = ("data", "model")
        batch_ax = None
    nsh = math.prod(int(mesh.shape[a]) for a in sp_axes)
    return sp_axes, nsh * cfg.lop_block, batch_ax


def build_decode_cell(cfg, shape, mesh):
    """→ (fn, args, master tree, layout): one rank's decode step over its
    cache shard with the whole served tree."""
    p_full, _ = abstract_params(cfg)
    qp = _served_tree(cfg)
    b = shape.global_batch
    sp_axes, align, batch_ax = decode_sharding(cfg, mesh, b)
    use_sp = cfg.family != "ssm"
    cache = init_cache(cfg, b, shape.seq_len, META, align=align)
    c_specs = cache_pspecs(cfg, cache, batch_axes=batch_ax,
                           seq_axes=sp_axes if use_sp else None)
    cache = _cut(cache, _shardings(mesh, _rank_cache_specs(c_specs,
                                                            batch_ax),
                                    cache), mesh)
    local = ShapeConfig(shape.name, shape.seq_len,
                        cache["lengths"].shape[0], shape.kind)
    tokens = input_specs(cfg, local)["tokens"]

    def fn_decode(qp, cache, tokens):
        return serve_step(cfg, qp, cache, tokens,
                          sp_axes=sp_axes if use_sp else None)

    dp = list(_dp(mesh)) if batch_ax else []
    sp = list(sp_axes) if use_sp else []
    layout = {"batch": dp, "params": [], "cache": dp + sp, "compute": dp,
              "attention": sp, "repeated": [a for a in mesh.axis_names
                                            if a not in dp]}
    return fn_decode, (qp, cache, tokens), p_full, layout


# ---------------------------------------------------------------------------
# Run one cell
# ---------------------------------------------------------------------------

def _build_and_trace(cfg, shape, mesh, *, n_micro: int):
    """Build the cell and trace its rank's program. → (trace, outputs,
    master tree, layout)."""
    with use_mesh(mesh):
        if shape.kind == "train":
            fn, args, p_full, layout = build_train_cell(
                cfg, shape, mesh, n_micro=n_micro)
        elif shape.kind == "prefill":
            fn, args, p_full, layout = build_prefill_cell(cfg, shape, mesh)
        else:
            fn, args, p_full, layout = build_decode_cell(cfg, shape, mesh)
        tr = OpTrace(seq_len=shape.seq_len + 1 if shape.kind == "decode"
                     else None)
        tr.arguments(*args)
        with tr:
            out = fn(*args)
    return tr, out, p_full, layout


def _variant_cfg(cfg, n_units: int):
    """Depth-``n_units`` variant for differential costing."""
    kw = {}
    if cfg.family == "hybrid":
        kw["n_layers"] = n_units * cfg.attn_every
    else:
        kw["n_layers"] = n_units
    if cfg.family == "encdec":
        kw["n_encoder_layers"] = n_units
    return cfg.replace(**kw)


def _depth_units(cfg) -> int:
    return (cfg.n_layers // cfg.attn_every if cfg.family == "hybrid"
            else cfg.n_layers)


def _cost_dict(tr) -> dict:
    return {"flops": tr.flops, "bytes": tr.bytes, "hbm": hbm_bytes(tr),
            "coll": collective_bytes(tr)["total"]}


def differential_cost(cfg, shape, mesh, *, n_micro: int = 1) -> dict:
    """Per-layer cost from the depth-1 and depth-2 variants, the
    reference's decomposition and output keys::

        per_layer = u(2) − u(1)      one layer
        base      = u(1) − per_layer embed / head / loss / optimizer
        total     = base + L·per_layer

    at the cell's own batch. The reference interpolated between two small
    batches because each probe was a compile; a meta trace is cheap, so
    the probes run at the cell's batch. Its trace counts every layer (the
    reference's ``cost_analysis`` counted a scan's body once), so
    ``total`` must equal the full-depth trace's cost: each quantity is an
    integer count, and ``self_check`` holds the difference (0 where the
    program is affine in depth)."""
    probes = {}
    for units in (1, 2):
        t0 = time.time()
        tr, _, _, _ = _build_and_trace(_variant_cfg(cfg, units), shape, mesh,
                                       n_micro=n_micro)
        probes[units] = _cost_dict(tr)
        del tr
        print(f"  [probe u{units} b{shape.global_batch}] "
              f"{time.time() - t0:.1f}s", flush=True)
    ell = _depth_units(cfg)
    keys = ("flops", "bytes", "hbm", "coll")
    delta = {k: probes[2][k] - probes[1][k] for k in keys}
    base = {k: probes[1][k] - delta[k] for k in keys}
    out = {k: base[k] + ell * delta[k] for k in keys}
    out["per_layer"] = delta
    out["base"] = base
    out["probes"] = {f"u{units}_b{shape.global_batch}": v
                     for units, v in probes.items()}
    return out


def _sorted(records: dict) -> dict:
    """Kernel records (``"name"``/``"name:mode"`` → launches), sorted."""
    return {k: records[k] for k in sorted(records)}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             n_micro: int | None = None, differential: bool = True,
             verbose: bool = True, cfg=None, shape=None) -> dict:
    """Trace one cell → the reference's per-cell record (``trace_s`` in
    place of its ``compile_s``), plus ``fits`` and ``layout``. ``shape``:
    a :class:`ShapeConfig` in place of ``SHAPES[shape_name]`` (the CPU
    tests' smoke shapes)."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "kind": shape.kind}

    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        result["status"] = "skip"
        result["reason"] = reason
        return result

    if n_micro is None:
        n_micro = 8 if shape.kind == "train" else 1

    mesh = make_production_mesh(multi_pod=multi_pod)
    if verbose:
        print(f"[{arch} × {shape_name} × {mesh_name}] tracing...", flush=True)
    t0 = time.time()
    tr, out, p_full, layout = _build_and_trace(cfg, shape, mesh,
                                               n_micro=n_micro)
    t_trace = time.time() - t0
    mem = tr.memory(out)
    del out
    coll = collective_bytes(tr)
    raw = {"flops": tr.flops, "bytes": tr.bytes, "hbm": hbm_bytes(tr),
           "int8_ops": tr.int8_ops, "coll": coll, "ops": tr.ops,
           "kernels": _sorted(tr.kernels)}
    full_cost = _cost_dict(tr)
    del tr

    # differential costing (single-pod roofline table only, as the
    # reference's)
    corrected = None
    if differential and not multi_pod:
        t1 = time.time()
        corrected = differential_cost(cfg, shape, mesh, n_micro=n_micro)
        corrected["variant_trace_s"] = round(time.time() - t1, 1)
        corrected["self_check"] = {k: corrected[k] - full_cost[k]
                                   for k in full_cost}

    n_params = count_params(p_full)
    n_active = active_params(cfg, n_params, p_full)
    chips = 512 if multi_pod else 256
    mf_global = model_flops(cfg, shape, n_params, n_active)
    if corrected is not None:
        # memory term from the fused-HBM model; raw bytes kept as the
        # unfused upper bound
        eff_cost = {"flops": corrected["flops"],
                    "bytes accessed": corrected["hbm"]}
        eff_coll = {"total": corrected["coll"]}
    else:
        eff_cost = {"flops": raw["flops"], "bytes accessed": raw["bytes"]}
        eff_coll = {"total": coll["total"]}
    terms = roofline_terms(eff_cost, eff_coll,
                           model_flops_per_chip=mf_global / chips)
    if corrected is not None:
        terms["memory_s_raw_upper"] = corrected["bytes"] / HBM_BW

    result.update({
        "status": "ok",
        "chips": chips,
        "n_params": n_params,
        "n_active_params": n_active,
        "n_micro": n_micro,
        "trace_s": round(t_trace, 1),
        "memory": mem,
        "fits": mem["peak_estimate_bytes"] <= HBM_BYTES,
        "layout": layout,
        "roofline": terms,
        "raw_scan_cost": raw,
        "differential": corrected,
    })
    if verbose:
        print(f"[{arch} × {shape_name} × {mesh_name}] OK "
              f"trace {t_trace:.1f}s "
              f"dominant={terms['dominant']} bound={terms['bound_s']:.2e}s "
              f"peak/rank={mem['peak_estimate_bytes'] / 2**30:.2f}GiB "
              f"fits={result['fits']}", flush=True)
        print("memory:", mem)
        print("kernels:", raw["kernels"])
    return result


def full_configs() -> list:
    """Every architecture's full config (the reference's registry)."""
    return [name for name in all_configs() if not name.endswith("-reduced")]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="architecture id (default: every full config)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None],
                    help="input shape (default: all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--n-micro", type=int, default=None,
                    help="default: 8 for train cells, 1 otherwise")
    ap.add_argument("--no-differential", action="store_true",
                    help="skip the depth probes (the full trace only)")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else full_configs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape_name}__{'mp' if mp else 'sp'}"
                try:
                    res = run_cell(arch, shape_name, multi_pod=mp,
                                   n_micro=args.n_micro,
                                   differential=not args.no_differential)
                except Exception as e:   # noqa: BLE001 — report, keep going
                    res = {"arch": arch, "shape": shape_name,
                           "mesh": "pod2x16x16" if mp else "pod16x16",
                           "status": "fail", "error": repr(e),
                           "traceback": traceback.format_exc()}
                    failures += 1
                    print(f"[{tag}] FAIL: {e}")
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(res, f, indent=1)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
