"""The port's side of ``tests/test_torch_distributed.py``: its inputs,
configs and the work of one rank (or of a single-process mesh), in a
module of its own that imports neither JAX nor the test module, so that
the gloo ranks ``spawn_ranks`` starts on it import only torch and the
port."""
import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.distributed.collective_matmul import (allgather_matmul,
                                                       ring_reduce_matmul)
from repro_torch.distributed.expert_parallel import ep_moe_apply
from repro_torch.distributed.fault_tolerance import (elastic_restart,
                                                     make_elastic_mesh)
from repro_torch.distributed.partitioning import psum_scatter, use_mesh
from repro_torch.convert import from_numpy_tree
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.serving import engine as teng
from repro_torch.training.optimizer import adamw_init
from repro_torch.training.train import (gather_tree, make_train_step,
                                        shard_dims, shard_tree)
from repro_torch.tree_util import flatten_with_path, tree_map
from torch_step_check import FAULTS, STEP, local_sharded_step, planted

torch.set_num_threads(1)

WORLD = 8
B, K, N = 4, 64, 32                 # the collective matmuls
EP_CFG = dict(capacity_factor=8.0, moe_group=64, quant="bf16")
FSDP_CFG = dict(n_layers=2, act_dtype="float32")
SP_LEN, SP_MAX_LEN, SP_STEPS = 40, 127, 6
SP_ARMS = {"jamba-lop": ("jamba", True), "jamba-dense": ("jamba", False),
           "rwkv": ("rwkv", True)}
# the arms the reference runs (rwkv6 ignores sp_axes on both sides) and
# the arm the gloo ranks run (the hybrid's sequence-parallel attention)
SP_REF_ARMS, SP_RANK_ARMS = ("jamba-lop", "rwkv"), ("jamba-lop",)
NAMES = {"granite": "granite-moe-1b-a400m-reduced",
         "stable": "stablelm-1.6b-reduced",
         "jamba": "jamba-1.5-large-398b-reduced", "rwkv": "rwkv6-1.6b-reduced"}
SURVIVORS = list(range(5))          # ranks 5-7 are the lost ones


def cfgs(get=get_config) -> dict:
    """The four configs, from ``get`` (the port's registry, or the
    reference's)."""
    c = {k: get(v) for k, v in NAMES.items()}
    c["granite"] = c["granite"].replace(**EP_CFG)
    c["stable"] = c["stable"].replace(**FSDP_CFG)
    return c


def inputs() -> dict:
    rng = np.random.default_rng(0)
    cfg = cfgs()
    f32 = np.float32
    return {
        "x_loc": rng.standard_normal((8, B, K // 8)).astype(f32),
        "w_loc": rng.standard_normal((8, K // 8, N)).astype(f32),
        "w_full": rng.standard_normal((K, N)).astype(f32),
        "x_batch": rng.standard_normal((8 * B, K)).astype(f32),
        "ep_x": rng.standard_normal((4, 16, cfg["granite"].d_model)).astype(
            f32),
        "tokens": rng.integers(0, cfg["stable"].vocab, (8, 16)).astype(
            np.int32),
        "labels": rng.integers(0, cfg["stable"].vocab, (8, 16)).astype(
            np.int32),
        "jamba": rng.integers(0, cfg["jamba"].vocab, (4, SP_LEN)).astype(
            np.int32),
        "rwkv": rng.integers(0, cfg["rwkv"].vocab, (4, SP_LEN)).astype(
            np.int32),
    }


def collectives(mesh, t) -> dict:
    if mesh.local:
        xl, wl, xb = t["x_loc"], t["w_loc"], t["x_batch"].reshape(8, B, K)
    else:
        r = mesh.rank("data")
        xl, wl, xb = t["x_loc"][r], t["w_loc"][r], t["x_batch"][
            r * B:(r + 1) * B]
    return {"ring": ring_reduce_matmul(xl, wl, "data", chunks=4, mesh=mesh),
            "allgather": allgather_matmul(xb, t["w_full"], "data",
                                          mesh=mesh),
            # each rank's product, summed and cut into 8 row blocks
            "psum_scatter": psum_scatter(
                torch.matmul(xl.contiguous(), wl.contiguous())
                if not mesh.local else torch.stack([
                    torch.matmul(a.contiguous(), b.contiguous())
                    for a, b in zip(xl, wl)]), "data", 1, mesh)}


def ep(mesh, t, moe) -> torch.Tensor:
    return ep_moe_apply(cfgs()["granite"], moe, t["ep_x"], mesh)


def _keyed(tree) -> dict:
    return dict(flatten_with_path(tree))


def fsdp_step(mesh, params, t, fault=None) -> dict:
    """One sharded step from ``params`` on a process group (with
    ``fault`` planted) → the loss, the grad norm, the shapes this rank
    held, and the whole new masters and moments by path."""
    cfg = cfgs()["stable"]
    dims = shard_dims(cfg, params, mesh)
    p = shard_tree(params, dims, mesh)
    held = {path: tuple(x.shape) for path, x in flatten_with_path(p)}
    step = make_train_step(cfg, mesh=mesh, dims=dims, **STEP)
    with planted(fault):
        p, opt, m = step(p, adamw_init(p), {k: t[k] for k in
                                            ("tokens", "labels")})
    opt = gather_tree(opt, dims, mesh)
    return {"loss": m["loss"], "grad_norm": m["grad_norm"], "held": held,
            "p": _keyed(gather_tree(p, dims, mesh)), "m": _keyed(opt.m),
            "v": _keyed(opt.v)}


def local_fsdp_step(mesh, params, t) -> dict:
    """The ranks' step in one process (``local_sharded_step``; ``mesh``
    None: the mesh-less step on the whole batch) from a copy of
    ``params`` → as :func:`fsdp_step`, without ``held``."""
    cfg = cfgs()["stable"]
    p = tree_map(torch.clone, params)
    batch = {k: t[k] for k in ("tokens", "labels")}
    if mesh is None:
        p, opt, m = make_train_step(cfg, **STEP)(p, adamw_init(p), batch)
    else:
        p, opt, m = local_sharded_step(cfg, mesh, p, adamw_init(p), batch,
                                       **STEP)
    return {"loss": m["loss"], "grad_norm": m["grad_norm"], "p": _keyed(p),
            "m": _keyed(opt.m), "v": _keyed(opt.v)}


def sp_serve(mesh, arm, qp, t) -> np.ndarray:
    """Greedy tokens [B, SP_STEPS]: a whole prefill, then decode steps
    with ``sp_axes=("model",)`` under ``mesh`` (None: unsharded)."""
    name, use_lop = SP_ARMS[arm]
    cfg = cfgs()[name]
    logits, cache = teng.prefill(cfg, qp, t[name].long(),
                                 max_len=SP_MAX_LEN)
    tok = logits.argmax(-1)
    toks = [tok]
    with use_mesh(mesh):
        if mesh is not None:
            cache = teng.shard_cache(cache)
        for _ in range(SP_STEPS - 1):
            logits, cache = teng.serve_step(
                cfg, qp, cache, tok[:, None], use_lop=use_lop,
                sp_axes=("model",) if mesh is not None else None)
            tok = logits.argmax(-1)
            toks.append(tok)
    return torch.stack(toks, 1).numpy()


def run_ranks(mesh8, inp, weights, ckpt_dir) -> dict:
    """One rank of the 8: every mesh is built by all 8 in one order."""
    t = {k: torch.from_numpy(np.array(v)) for k, v in inp.items()}
    w = {k: from_numpy_tree(v, "cpu") for k, v in weights.items()}
    res = {"collectives": collectives(mesh8, t)}
    mesh22 = make_host_mesh((2, 2), ("data", "model"), ranks=range(4))
    if mesh22 is not None:
        res["ep"] = ep(mesh22, t, w["moe"])
    if mesh22 is not None:
        for fault in FAULTS:
            res[f"fsdp/{fault}"] = fsdp_step(mesh22, w["stable"], t, fault)
    res["fsdp"] = fsdp_step(make_host_mesh((2, 4), ("data", "model")),
                            w["stable"], t)
    if mesh8.rank("data") in SURVIVORS:
        mesh, tree, step, _ = elastic_restart(
            ckpt_dir, {"params": w["stable"]}, SURVIVORS, model=4)
        res["elastic_mesh"] = None if mesh is None else dict(mesh.shape)
        res["restored_step"] = step
        if mesh is not None:
            res["elastic"] = fsdp_step(mesh, tree["params"], t)
    else:
        # a lost rank: it takes part in making the groups, in none of them
        assert make_elastic_mesh(SURVIVORS, model=4) is None
    mesh2 = make_host_mesh((2,), ("model",), ranks=range(2))
    if mesh2 is not None:
        res["sp"] = {arm: sp_serve(mesh2, arm, w[SP_ARMS[arm][0]], t)
                     for arm in SP_RANK_ARMS}
    return res
