"""The distributed modules on the CPU, held against the reference: the
ring collective matmuls, expert-parallel MoE, the sharded training step
with its elastic restart, and sequence-parallel decode of the hybrid and
ssm families.

The port runs once in 8 processes joined in a gloo group
(``tests/torch_dist_ranks.py``; each rank builds the meshes it takes part
in: 8 data ranks for the matmuls, (data 2, model 2) over ranks 0-3 for
EP and the planted faults, (data 2, model 4) over all 8 for the sharded
step, the (1, 4) elastic mesh over the first 4 of 5 survivors, and a
2-rank model axis for SP decode), and once more on single-process meshes
in this process. The reference runs in a child process with 8 XLA host
devices, as ``tests/subproc/collectives_check.py`` and
``tests/subproc/fsdp_train_check.py`` do, on the same numpy inputs and
weights (drawn by the port: its master and serving trees are the
reference's, leaf for leaf):

  * ``ring_reduce_matmul`` and ``allgather_matmul`` at the reference's
    shapes within 1e-4 of the reference (and of the numpy product), and
    ``psum_scatter`` of the ranks' products within 1e-5 of their sum;
  * ``ep_moe_apply`` on granite reduced (8 experts, top-4; bf16, capacity
    factor 8) at (data 2, model 4), two experts a rank, and at (2, 2),
    within 2e-3 of the reference's ``ep_moe_apply`` at (2, 4);
  * the sharded step on stablelm reduced (2 layers, f32, lr 1e-4 at step
    1) at (data 2, model 4), and the elastic restart's step at (1, 4):
    held to the port's single-device step by ``tests/torch_step_check.py``
    (each leaf's update and both moments), to the reference's
    single-device and sharded steps by the loss within rtol 1e-4 and the
    update's bounds; the same check fails on a skipped, a flipped and a
    misplaced-block step; a rank holds 1/8 of a leaf cut on both axes;
  * ``param_specs`` leaf for leaf the reference's partition specs, one
    reduced config a family;
  * the elastic restart: 5 survivors → (1, 4), the spare sits out;
  * ``serve_step(sp_axes=("model",))`` on jamba reduced (LOP and dense)
    and rwkv6 reduced at n = 2: greedy tokens equal the port's own
    unsharded decode; jamba LOP and rwkv6 (which ignores ``sp_axes``)
    equal the reference's; jamba LOP also over 2 gloo ranks.

The gloo ranks are bitwise the single-process meshes throughout (for the
sharded step, the single-process emulation of its ranks in
``tests/torch_step_check.py``).
"""
import importlib
import os
import pickle
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as dr
import torch_step_check as sc
from repro.models.transformer import init_params as jinit
from repro_torch.checkpoint.store import save_checkpoint
from repro_torch.convert import from_numpy_tree
from repro_torch.distributed.fault_tolerance import plan_elastic_mesh
from repro_torch.launch.mesh import local_mesh, spawn_ranks
from repro_torch.configs import get_config
from repro_torch.models.transformer import (init_params, moe_init,
                                            param_specs)
from repro_torch.serving.quantize import init_serving_params
from repro_torch.training.train import _spec_paths
from repro_torch.tree_util import flatten_with_path, tree_map

torch.set_num_threads(1)

def jget_config(name: str):
    """The reference's reduced config of the port's ``name``."""
    module = name.removesuffix("-reduced").replace("-", "_").replace(".",
                                                                     "_")
    return importlib.import_module(f"repro.configs.{module}").REDUCED


def _weights() -> dict:
    """The weights as numpy trees, drawn by the port from seed 0 (its
    trees are the reference's, leaf for leaf): the MoE layer, the
    stablelm masters, the quantized jamba and rwkv6 serving trees."""
    cfg = dr.cfgs()
    gen = torch.Generator()
    gen.manual_seed(0)
    out = {"moe": moe_init(gen, cfg["granite"], device="cpu"),
           "stable": init_params(cfg["stable"], 0)}
    for name in ("jamba", "rwkv"):
        out[name] = init_serving_params(cfg[name], 0, "cpu")
    return tree_map(lambda x: x.numpy(), out)


# ---------------------------------------------------------------------------
# the reference, in a child process with 8 host devices
# ---------------------------------------------------------------------------

def _reference(path: str, weights_path: str) -> None:
    from repro.distributed.collective_matmul import (
        allgather_matmul as jag, ring_reduce_matmul as jring)
    from repro.distributed.expert_parallel import ep_moe_apply as jep
    from repro.distributed.partitioning import P, shard_map
    from repro.distributed.partitioning import use_mesh as juse_mesh
    from repro.launch.dryrun import _shardings
    from repro.launch.mesh import make_host_mesh as jmesh
    from repro.serving.engine import prefill as jprefill
    from repro.serving.engine import serve_step as jserve
    from repro.training.optimizer import adamw_init as jadamw_init
    from repro.training.train import make_train_step

    inp, cfg = dr.inputs(), dr.cfgs(jget_config)
    with open(weights_path, "rb") as f:
        w = jax.tree.map(jnp.asarray, pickle.load(f))
    res = {}
    mesh8 = jmesh((8,), ("data",))
    ring = shard_map(
        lambda xl, wl: jring(xl[0], wl[0], "data", chunks=4)[None],
        mesh=mesh8, in_specs=(P("data"), P("data")), out_specs=P("data"),
        check_vma=False)
    res["ring"] = np.asarray(ring(jnp.asarray(inp["x_loc"]),
                                  jnp.asarray(inp["w_loc"])))
    ag = shard_map(lambda xl, wl: jag(xl, wl, "data"), mesh=mesh8,
                   in_specs=(P("data"), P(None, None)),
                   out_specs=P("data"), check_vma=False)
    res["allgather"] = np.asarray(ag(jnp.asarray(inp["x_batch"]),
                                     jnp.asarray(inp["w_full"])))
    res["ep"] = np.asarray(jep(cfg["granite"], w["moe"],
                               jnp.asarray(inp["ep_x"]),
                               jmesh((2, 4), ("data", "model")),
                               axis="model"))

    scfg = cfg["stable"]
    params = w["stable"]
    # the partition specs alone, from a tiny tree of the same structure
    pspecs = jinit(scfg.replace(d_model=8, d_ff=8, n_heads=1, n_kv_heads=1,
                                head_dim=8, vocab=8),
                   jax.random.PRNGKey(0))[1]
    batch = {k: jnp.asarray(inp[k]) for k in ("tokens", "labels")}
    step = jax.jit(make_train_step(scfg, **sc.STEP))
    arms = {"single": None, "sharded": jmesh((2, 4), ("data", "model"))}
    for arm, mesh in arms.items():
        opt = jadamw_init(params)
        if mesh is None:
            p, o, m = step(params, opt, batch)
        else:
            with juse_mesh(mesh):
                p, o, m = step(
                    jax.device_put(params, _shardings(mesh, pspecs, params)),
                    jax.device_put(opt, _shardings(
                        mesh, type(opt)(step=(), m=pspecs, v=pspecs), opt)),
                    jax.device_put(batch, _shardings(
                        mesh, {k: ("dp", None) for k in batch}, batch)))
        res[f"fsdp/{arm}/loss"] = np.asarray(m["loss"])
        for part, tree in (("p", p), ("m", o.m), ("v", o.v)):
            for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
                res[f"fsdp/{arm}/{part}{jax.tree_util.keystr(kp)}"] = \
                    np.asarray(leaf)

    sp_mesh = jmesh((4, 2), ("data", "model"))
    for arm in dr.SP_REF_ARMS:
        name, use_lop = dr.SP_ARMS[arm]
        logits, cache = jprefill(cfg[name], w[name], jnp.asarray(inp[name]),
                                 max_len=dr.SP_MAX_LEN)
        tok = jnp.argmax(logits, -1)
        toks = [np.asarray(tok)]
        with juse_mesh(sp_mesh):
            serve = jax.jit(lambda qp_, c, t, c_=cfg[name], u=use_lop: jserve(
                c_, qp_, c, t, use_lop=u, sp_axes=("model",)))
            for _ in range(dr.SP_STEPS - 1):
                logits, cache = serve(w[name], cache, tok[:, None])
                tok = jnp.argmax(logits, -1)
                toks.append(np.asarray(tok))
        res[f"sp/{arm}"] = np.stack(toks, 1)
    np.savez(path, **res)


@pytest.fixture(scope="module")
def runs():
    """(reference, [rank results], single-process results)."""
    inp, weights = dr.inputs(), _weights()
    t = {k: torch.from_numpy(np.array(v)) for k, v in inp.items()}
    w = {k: from_numpy_tree(v, "cpu") for k, v in weights.items()}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "reference.npz")
        weights_path = os.path.join(tmp, "weights.pkl")
        with open(weights_path, "wb") as f:
            pickle.dump(weights, f)
        ckpt = os.path.join(tmp, "ckpt")
        save_checkpoint(ckpt, 3, {"params": w["stable"]})
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=8")
        child = subprocess.Popen([sys.executable, __file__, "--reference",
                                  path, weights_path], env=env,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
        try:
            ranks = spawn_ranks("torch_dist_ranks:run_ranks", dr.WORLD,
                                (inp, weights, ckpt), shape=(dr.WORLD,),
                                axes=("data",), timeout=600)
            local = {
                "collectives": dr.collectives(local_mesh((8,), ("data",)),
                                              t),
                "ep24": dr.ep(local_mesh((2, 4), ("data", "model")), t,
                              w["moe"]),
                "ep22": dr.ep(local_mesh((2, 2), ("data", "model")), t,
                              w["moe"]),
                "fsdp": dr.local_fsdp_step(
                    local_mesh((2, 4), ("data", "model")), w["stable"], t),
                "elastic": dr.local_fsdp_step(
                    local_mesh((1, 4), ("data", "model")), w["stable"], t),
                "single": dr.local_fsdp_step(None, w["stable"], t),
                "p0": dict(flatten_with_path(w["stable"])),
                "sp": {arm: dr.sp_serve(local_mesh((2,)), arm,
                                        w[dr.SP_ARMS[arm][0]], t)
                       for arm in dr.SP_ARMS},
                "sp_single": {arm: dr.sp_serve(None, arm,
                                               w[dr.SP_ARMS[arm][0]], t)
                              for arm in dr.SP_ARMS}}
            out, _ = child.communicate(timeout=600)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
        assert child.returncode == 0, out
        with np.load(path) as f:
            ref = dict(f)
    return ref, ranks, local


def test_collective_matmuls_match_reference(runs):
    ref, ranks, local = runs
    inp = dr.inputs()
    want = sum(inp["x_loc"][i] @ inp["w_loc"][i] for i in range(8))
    rows = 8 * dr.B
    for r, res in enumerate(ranks):
        got = res["collectives"]
        np.testing.assert_allclose(got["ring"].numpy(), ref["ring"][r],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got["ring"].numpy(), want, rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(got["allgather"].numpy(),
                                   ref["allgather"][r * rows:(r + 1) * rows],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got["allgather"].numpy(),
                                   inp["x_batch"] @ inp["w_full"],
                                   rtol=1e-4, atol=1e-4)
        # a sum of 8 in gloo's order (2 ranks add alike: the sharded
        # step's gradients are bitwise the single-process mesh's)
        for got_ps in (got["psum_scatter"],
                       local["collectives"]["psum_scatter"][r]):
            np.testing.assert_allclose(got_ps.numpy(),
                                       want[:, r * 4:(r + 1) * 4],
                                       rtol=1e-5, atol=1e-5)
        for key in ("ring", "allgather"):
            np.testing.assert_array_equal(got[key].numpy(),
                                          local["collectives"][key][r].numpy())


def test_ep_moe_matches_reference(runs):
    """Every rank returns the whole batch's rows; the single-process
    mesh's carry the mesh dims (data gathered to 1, model 4 or 2)."""
    ref, ranks, local = runs
    for key, n_model in (("ep24", 4), ("ep22", 2)):
        assert local[key].shape[:2] == (1, n_model), key
        for m in range(n_model):
            np.testing.assert_allclose(local[key][0, m].numpy(), ref["ep"],
                                       rtol=2e-3, atol=2e-3, err_msg=key)
    for r in range(4):
        np.testing.assert_array_equal(ranks[r]["ep"].numpy(),
                                      local["ep22"][0, r % 2].numpy())


def _step_sums(got: dict, want: dict, p0: dict) -> dict:
    """{path: the step check's sums} of a step (``got``: p, m, v by path)
    against ``want`` (the same), both from the masters ``p0``."""
    return {path: sc.leaf_sums(
        p0[path], [got[part][path] for part in ("p", "m", "v")],
        [torch.as_tensor(want[part][path]) for part in ("p", "m", "v")])
        for path in got["p"]}


def _reference_step(ref: dict, arm: str) -> dict:
    return {part: {k.removeprefix(f"fsdp/{arm}/{part}"): v
                   for k, v in ref.items()
                   if k.startswith(f"fsdp/{arm}/{part}[")}
            for part in ("p", "m", "v")}


@pytest.mark.parametrize("arm", ["sharded", "elastic"])
def test_sharded_step_matches_reference(runs, arm):
    """The gloo ranks' step, lr 1e-4 at step 1 (``torch_step_check.STEP``):
    every rank bitwise the single-process emulation of the ranks; held to
    the port's single-device step by the whole step check (loss rtol
    1e-4, measured 0; update gap 1.6e-6 of its norm, 1.5e-4·lr in an
    element, moments 3.7e-7); to the reference's single-device and
    sharded steps by the loss within rtol 1e-4 (measured 2.8e-5) and the
    update's bounds (measured 5.9e-4 of its norm, 0.040·lr). The moments
    are not held to the reference's: its single-device step parts from
    the port's by 3.4e-3 of their norm at this batch, the sharding adding
    nothing to that."""
    ref, ranks, local = runs
    key = "fsdp" if arm == "sharded" else "elastic"
    on_mesh = [res[key] for res in ranks if res.get(key) is not None]
    assert len(on_mesh) == (8 if arm == "sharded" else 4)
    for res in on_mesh:
        for k in ("loss", "grad_norm"):
            assert torch.equal(res[k], local[key][k]), k
        for part in ("p", "m", "v"):
            for path, leaf in res[part].items():
                assert torch.equal(leaf, local[key][part][path]), (part,
                                                                   path)
    got = on_mesh[0]
    assert np.isclose(float(got["loss"]), float(local["single"]["loss"]),
                      rtol=1e-4)
    assert sc.step_faults(_step_sums(got, local["single"], local["p0"]),
                          sc.STEP["peak_lr"]) == []
    for want in ("single", "sharded"):
        assert np.isclose(float(got["loss"]),
                          float(ref[f"fsdp/{want}/loss"]), rtol=1e-4), want
        sums = _step_sums(got, _reference_step(ref, want), local["p0"])
        assert sc.step_faults(sums, sc.STEP["peak_lr"],
                              moments=False) == [], want


@pytest.mark.parametrize("fault", sc.FAULTS)
def test_sharded_step_check_catches_planted_fault(runs, fault):
    """The check above fails on the gloo ranks' step at (data 2, model
    2) with the update skipped (``zero``: update gap 1.0 of its norm in
    every leaf), flipped (``sign``: 2.0), or each rank's gradient block
    taken at its model neighbour's coordinates (``swap``: m 1.47 of its
    norm, in the 9 leaves cut over the model axis)."""
    _, ranks, local = runs
    got = ranks[0][f"fsdp/{fault}"]
    assert sc.step_faults(_step_sums(got, local["single"], local["p0"]),
                          sc.STEP["peak_lr"])


PSPEC_ARCHS = ("bitnet-3b", "stablelm-1.6b", "qwen1.5-32b",
               "granite-moe-1b-a400m", "llava-next-34b", "whisper-small",
               "rwkv6-1.6b", "jamba-1.5-large-398b")


@pytest.mark.parametrize("arch", PSPEC_ARCHS)
def test_param_specs_match_reference(arch):
    """``param_specs`` on the port's reduced masters equals, leaf for
    leaf, the partition specs the reference's ``init_params`` returns
    (traced abstractly, nothing drawn)."""
    name = f"{arch}-reduced"
    specs = {}

    def draw(key):
        params, specs["ref"] = jinit(jget_config(name), key)
        return params
    jax.eval_shape(draw, jax.random.PRNGKey(0))
    want = {jax.tree_util.keystr(kp): tuple(v) for kp, v in
            jax.tree_util.tree_flatten_with_path(
                specs["ref"], is_leaf=lambda x: isinstance(x, tuple))[0]}
    cfg = get_config(name)
    got = dict(_spec_paths(param_specs(cfg, init_params(cfg, 0))))
    assert got == want


def test_sharded_step_holds_shards(runs):
    """Each rank of (data 2, model 4) holds 1/8 of a leaf cut on both
    axes and the whole of a replicated one; the embedding [vocab, d] is
    cut vocab over model and d over data."""
    _, ranks, local = runs
    whole = {path: tuple(x.shape) for path, x in
             local["fsdp"]["p"].items()}
    held = ranks[5]["fsdp"]["held"]
    v, d = whole["['embed']['table']"]
    assert held["['embed']['table']"] == (v // 4, d // 2)
    assert held["['ln_f']['g']"] == whole["['ln_f']['g']"]
    n, k, m = whole["['layers']['attn']['wq']['w']"]
    assert held["['layers']['attn']['wq']['w']"] == (n, k // 2, m // 4)


def test_elastic_restart_mesh(runs):
    _, ranks, _ = runs
    assert plan_elastic_mesh(8, model=4) == (2, 4)
    assert plan_elastic_mesh(5, model=4) == (1, 4)
    for r in dr.SURVIVORS:
        assert ranks[r]["restored_step"] == 3
        assert ranks[r]["elastic_mesh"] == (
            {"data": 1, "model": 4} if r < 4 else None)
    for r in range(5, 8):
        assert "elastic_mesh" not in ranks[r]


@pytest.mark.parametrize("arm", list(dr.SP_ARMS))
def test_sp_decode_recurrent_matches_reference(runs, arm):
    """The sequence-parallel greedy streams equal the port's unsharded
    decode and the reference's sequence-parallel decode."""
    ref, ranks, local = runs
    np.testing.assert_array_equal(local["sp"][arm],
                                  local["sp_single"][arm])
    if arm in dr.SP_REF_ARMS:
        np.testing.assert_array_equal(local["sp"][arm], ref[f"sp/{arm}"])
    if arm in dr.SP_RANK_ARMS:
        for r in range(2):
            np.testing.assert_array_equal(ranks[r]["sp"][arm],
                                          local["sp"][arm])


if __name__ == "__main__":
    if sys.argv[1:2] == ["--reference"]:
        _reference(sys.argv[2], sys.argv[3])
