"""Sequence-parallel decode and f-axis FFN tensor parallelism on the CPU,
held against the reference under a 4-way model axis.

The port runs in 4 processes joined in a gloo group (spawned once for the
module, each holding its token shard of the cache), and once more on a
single-process mesh in this process. The reference runs in a child
process with 8 XLA host devices on a (data 2, model 4) mesh, as
``tests/subproc/sp_decode_check.py`` does, on the same numpy inputs:

  * ``sp_decode_attention`` at ``lop_keep`` 1 and with quotas, with
    shared selection (G 2), retired lanes, a window across a shard's edge
    and the dense mode: caches bitwise (the owner shard alone writes),
    outputs within rtol = atol = 2e-5, every rank's output bitwise the
    others';
  * ``ffn_fused_tp`` gated (silu) and ungated (squared relu) at n = 4
    within 2e-5 of the reference, and bitwise the unsharded #2 at n = 1;
  * greedy ``serve_step(sp_axes=("model",))`` on ``bitnet-3b-reduced``
    (two 100-token prompts, capacity 256: 2 blocks a shard), with and
    without ``use_ffn_tp``: tokens equal the reference's token for token
    up to one pinned parting (lane 1, token 2), which the single-device
    decode of both sides shares and which starts in the prefill's rounding
    (layer 0's f32 scales apart by ulps, int8 flips from layer 1 on): a
    rounding near-tie, not the sequence-parallel path.
"""
import os
import subprocess
import sys
import tempfile
from contextlib import nullcontext

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.bitnet_3b import REDUCED as JCFG
from repro.core.lop import lop_features, pack_features
from repro.kernels import ops as jops
from repro.models.transformer import init_params as jinit
from repro.serving.quantize import quantize_params as jquantize
from repro_torch.configs import get_config
from repro_torch.convert import from_numpy_tree
from repro_torch.distributed.partitioning import use_mesh
from repro_torch.distributed.sp_decode import sp_decode_attention
from repro_torch.distributed.tp_ffn import ffn_fused_tp, use_ffn_tp
from repro_torch.kernels import ops as tops
from repro_torch.launch.mesh import local_mesh, spawn_ranks
from repro_torch.serving import engine as teng

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)
N = 4                                   # the model axis
B, H, HKV, DH, M = 4, 8, 4, 32, 512     # G 2; 16 blocks of 32, 4 a shard
LENGTHS = [472, 100, 300, 511]          # lane 1: shards 1-3 empty
KEYS = ("k", "v", "k_scale", "v_scale", "feat")
CASES = {
    "keep1": dict(keep=1.0),
    "quota": dict(keep=0.25),
    "quota-shared": dict(keep=0.25, shared=True),
    "retired": dict(keep=0.25, active=[True, False, True, True]),
    "window": dict(keep=0.5, window=100),
    "dense": dict(keep=0.25, use_lop=False),
}
D, F = 128, 256                          # the tp_ffn operands
FFN_ARMS = {"gated-silu": (True, "silu"),
            "ungated-squared_relu": (False, "squared_relu")}
SERVE_LEN, SERVE_MAX_LEN, SERVE_STEPS = 100, 255, 8
SERVE_ARMS = {"sp": (True, False), "sp-tp": (True, True),
              "single": (False, False)}     # (sequence-parallel, f-axis TP)
PARTED = (1, 2)            # (lane, token) where the streams part, pinned
CFG = get_config("bitnet-3b-reduced")


def _inputs() -> dict:
    rng = np.random.default_rng(0)

    def i8(shape):
        return rng.integers(-60, 61, shape).astype(np.int8)

    def sc(shape):
        return rng.uniform(0.005, 0.02, shape).astype(np.float32)
    d = dict(qi=i8((B, H, DH)), qsc=sc((B, H, 1)), ki=i8((B, HKV, DH)),
             vi=i8((B, HKV, DH)), ksc=sc((B, HKV, 1)), vsc=sc((B, HKV, 1)),
             k=i8((B, HKV, M, DH)), v=i8((B, HKV, M, DH)),
             k_scale=sc((B, HKV, M)), v_scale=sc((B, HKV, M)),
             lengths=np.asarray(LENGTHS, np.int32))
    d["feat_new"] = np.asarray(pack_features(lop_features(jnp.asarray(
        d["ki"]))))
    d["feat"] = np.asarray(pack_features(lop_features(jnp.asarray(d["k"]))))
    d["x"] = rng.standard_normal((4, D)).astype(np.float32)
    for name, (gated, _) in FFN_ARMS.items():
        n_gu = 2 * F if gated else F
        d[f"{name}/gu"] = rng.integers(0, 256, (D // 4, n_gu)).astype(
            np.uint8)
        d[f"{name}/gs"] = rng.uniform(0.01, 0.05, (1, n_gu)).astype(
            np.float32)
        d[f"{name}/down"] = rng.integers(0, 256, (F // 4, D)).astype(
            np.uint8)
        d[f"{name}/ds"] = np.full((1, 1), 0.02, np.float32)
    d["prompts"] = rng.integers(0, CFG.vocab, (2, SERVE_LEN)).astype(
        np.int32)
    return d


def _ffn_args(inp, name):
    return tuple(inp[f"{name}/{k}"] for k in ("gu", "gs", "down", "ds"))


# ---------------------------------------------------------------------------
# the reference, in a child process with 8 host devices
# ---------------------------------------------------------------------------

def _reference(path: str) -> None:
    from repro.distributed.partitioning import use_mesh as juse_mesh
    from repro.distributed.sp_decode import sp_decode_attention as jsp
    from repro.distributed.tp_ffn import ffn_fused_tp as jtp
    from repro.distributed.tp_ffn import use_ffn_tp as juse_tp
    from repro.launch.mesh import make_host_mesh
    from repro.serving.engine import prefill as jprefill
    from repro.serving.engine import serve_step as jserve

    inp = _inputs()
    mesh = make_host_mesh((2, N), ("data", "model"))
    res = {}
    new = tuple(jnp.asarray(inp[k]) for k in ("ki", "vi", "ksc", "vsc",
                                              "feat_new"))
    for name, case in CASES.items():
        cfg = JCFG.replace(lop_keep=case["keep"],
                           gqa_shared_select=case.get("shared", False))
        active = case.get("active")
        active = None if active is None else jnp.asarray(active)

        def fn(qi, qsc, cl, lengths, cfg=cfg, case=case, active=active):
            return jsp(cfg, qi, qsc, *new, cl, lengths,
                       window=case.get("window", 0),
                       use_lop=case.get("use_lop", True), sp_axes=("model",),
                       active=active)
        with juse_mesh(mesh):
            out, cl = jax.jit(fn)(jnp.asarray(inp["qi"]),
                                  jnp.asarray(inp["qsc"]),
                                  {k: jnp.asarray(inp[k]) for k in KEYS},
                                  jnp.asarray(inp["lengths"]))
        res[f"{name}/out"] = np.asarray(out)
        for k in KEYS:
            res[f"{name}/{k}"] = np.asarray(cl[k])
    for name, (gated, act) in FFN_ARMS.items():
        for n, shape in ((N, (2, N)), (1, (8, 1))):
            with juse_mesh(make_host_mesh(shape, ("data", "model"))):
                res[f"tp/{name}/{n}"] = np.asarray(jax.jit(
                    lambda x, *a, g=gated, f=act: jtp(x, *a, gated=g, act=f))(
                    jnp.asarray(inp["x"]),
                    *map(jnp.asarray, _ffn_args(inp, name))))
    params, _ = jinit(JCFG, jax.random.PRNGKey(0))
    qp = jquantize(JCFG, params)
    for arm, (sp, tp) in SERVE_ARMS.items():
        logits, cache = jprefill(JCFG, qp, jnp.asarray(inp["prompts"]),
                                 max_len=SERVE_MAX_LEN)
        for k in KEYS[:4]:
            res[f"prefill/{k}"] = np.asarray(cache["layers"][k])
        tok = jnp.argmax(logits, -1)
        toks = [np.asarray(tok)]
        with juse_mesh(mesh if sp else None), (
                juse_tp() if tp else nullcontext()):
            step = jax.jit(lambda qp_, c, t, sp=sp: jserve(
                JCFG, qp_, c, t, sp_axes=("model",) if sp else None))
            for _ in range(SERVE_STEPS - 1):
                logits, cache = step(qp, cache, tok[:, None])
                tok = jnp.argmax(logits, -1)
                toks.append(np.asarray(tok))
        res[f"serve/{arm}"] = np.stack(toks, 1)
    np.savez(path, **res)


# ---------------------------------------------------------------------------
# the port: one function for a rank of a process group and for the
# single-process mesh (which sees the whole cache)
# ---------------------------------------------------------------------------

def _rows(mesh):
    """The cache rows this process holds."""
    if mesh.local:
        return slice(0, M)
    m_loc = M // N
    r = mesh.rank("model")
    return slice(r * m_loc, (r + 1) * m_loc)


def run_port(mesh, inp, tree) -> dict:
    t = {k: torch.from_numpy(np.array(v)) for k, v in inp.items()}
    rows = _rows(mesh)
    res = {}
    with use_mesh(mesh):
        for name, case in CASES.items():
            cfg = CFG.replace(lop_keep=case["keep"],
                              gqa_shared_select=case.get("shared", False))
            cl = {k: t[k][:, :, rows].clone() for k in KEYS}
            active = case.get("active")
            out, cl = sp_decode_attention(
                cfg, t["qi"], t["qsc"], t["ki"], t["vi"], t["ksc"], t["vsc"],
                t["feat_new"], cl, t["lengths"],
                window=case.get("window", 0),
                use_lop=case.get("use_lop", True), sp_axes=("model",),
                active=None if active is None else torch.tensor(active))
            res[f"{name}/out"] = out.numpy()
            for k in KEYS:
                res[f"{name}/{k}"] = cl[k].numpy()
        for name, (gated, act) in FFN_ARMS.items():
            res[f"tp/{name}"] = ffn_fused_tp(
                t["x"], *(t[f"{name}/{k}"] for k in ("gu", "gs", "down",
                                                      "ds")),
                gated=gated, act=act).numpy()
        qp = from_numpy_tree(tree, "cpu")
        for arm, (sp, tp) in SERVE_ARMS.items():
            if not (sp or mesh.local):
                continue                # the single-device arm: once
            logits, cache = teng.prefill(CFG, qp, t["prompts"].long(),
                                         max_len=SERVE_MAX_LEN)
            for k in KEYS[:4]:
                res[f"prefill/{k}"] = cache["layers"][k].numpy().copy()
            tok = logits.argmax(-1)
            toks = [tok]
            if sp:
                cache = teng.shard_cache(cache)
            with use_ffn_tp() if tp else nullcontext():
                for _ in range(SERVE_STEPS - 1):
                    logits, cache = teng.serve_step(
                        CFG, qp, cache, tok[:, None],
                        sp_axes=("model",) if sp else None)
                    tok = logits.argmax(-1)
                    toks.append(tok)
            res[f"serve/{arm}"] = torch.stack(toks, 1).numpy()
    return res


@pytest.fixture(scope="module")
def runs():
    """(reference, [rank results], single-process mesh results)."""
    inp = _inputs()
    params, _ = jinit(JCFG, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jquantize(JCFG, params))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "reference.npz")
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=8")
        child = subprocess.Popen([sys.executable, __file__, "--reference",
                                  path], env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
        try:
            ranks = spawn_ranks("test_torch_sp_decode:run_port", N,
                                (inp, tree), timeout=600)
            local = run_port(local_mesh((N,)), inp, tree)
            out, _ = child.communicate(timeout=600)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
        assert child.returncode == 0, out
        with np.load(path) as f:
            ref = dict(f)
    return ref, ranks, local


@pytest.mark.parametrize("case", list(CASES))
def test_sp_attention_matches_reference(runs, case):
    ref, ranks, local = runs
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res[f"{case}/out"], ref[f"{case}/out"],
                                   **TOL, err_msg=f"rank {r}")
        np.testing.assert_array_equal(res[f"{case}/out"],
                                      ranks[0][f"{case}/out"])
    np.testing.assert_allclose(local[f"{case}/out"], ref[f"{case}/out"],
                               **TOL)
    for k in KEYS:
        whole = np.concatenate([res[f"{case}/{k}"] for res in ranks], 2)
        np.testing.assert_array_equal(whole, ref[f"{case}/{k}"], err_msg=k)
        np.testing.assert_array_equal(local[f"{case}/{k}"],
                                      ref[f"{case}/{k}"], err_msg=k)


@pytest.mark.parametrize("case", ["keep1", "retired"])
def test_owner_shard_alone_writes(runs, case):
    """Only the shard owning ``lengths[b]`` writes lane b's token, at that
    row; a retired lane writes nothing."""
    _, ranks, _ = runs
    inp = _inputs()
    active = CASES[case].get("active", [True] * B)
    m_loc = M // N
    for r, res in enumerate(ranks):
        changed = (res[f"{case}/k"] != inp["k"][:, :, r * m_loc:
                                                (r + 1) * m_loc]).any(-1)
        for b in range(B):
            own = r * m_loc <= LENGTHS[b] < (r + 1) * m_loc and active[b]
            want = np.zeros((HKV, m_loc), bool)
            if own:
                want[:, LENGTHS[b] - r * m_loc] = (
                    inp["ki"][b] != inp["k"][b, :, LENGTHS[b]]).any(-1)
            np.testing.assert_array_equal(changed[b], want,
                                          err_msg=f"rank {r} lane {b}")


@pytest.mark.parametrize("use_lop", [True, False])
def test_empty_shard_stats(use_lop):
    """A shard whose rows all lie past new_len: m = −1e30, ℓ = 0, out = 0,
    as the reference kernel's plain version gives them."""
    inp = _inputs()
    rows = slice(3 * M // N, M)
    args = [inp["qi"], inp["qsc"]] + [inp[k][:, :, rows] for k in KEYS]
    new_len = np.asarray(LENGTHS, np.int32) + 1
    kw = dict(block=32, k_keep=1, use_lop=use_lop, pos_offset=3 * M // N,
              return_stats=True)
    t = tops.decode_attention(*map(torch.from_numpy, map(
        np.ascontiguousarray, args)), torch.from_numpy(new_len), **kw)
    j = jops.decode_attention(*map(jnp.asarray, args),
                              jnp.asarray(new_len), impl="ref", **kw)
    for a, b_ in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), **TOL)
    out, m, l = t
    for b in (1, 2):                    # new_len 101 and 301 < 384
        assert not out[b].any() and not l[b].any()
        assert (m[b] == -1e30).all()


@pytest.mark.parametrize("name", list(FFN_ARMS))
def test_tp_ffn_matches_reference(runs, name):
    ref, ranks, local = runs
    for res in ranks + [local]:
        np.testing.assert_allclose(res[f"tp/{name}"], ref[f"tp/{name}/{N}"],
                                   **TOL)
    for res in ranks:                   # one all_reduce: the same bits
        np.testing.assert_array_equal(res[f"tp/{name}"],
                                      ranks[0][f"tp/{name}"])


@pytest.mark.parametrize("name", list(FFN_ARMS))
def test_tp_ffn_one_rank_bitwise(runs, name):
    """At n = 1 the f-sharded FFN is bitwise the unsharded kernel, and
    agrees with the reference's n = 1 run."""
    ref, _, _ = runs
    inp = _inputs()
    gated, act = FFN_ARMS[name]
    args = (inp["x"],) + _ffn_args(inp, name)
    t = tuple(map(torch.from_numpy, args))
    with use_mesh(local_mesh((1,))):
        got = ffn_fused_tp(*t, gated=gated, act=act)
    assert torch.equal(got, tops.ffn_fused(*t, gated=gated, act=act))
    np.testing.assert_allclose(got.numpy(), ref[f"tp/{name}/1"], **TOL)


def _first_parting(a, b):
    """(lane, token) of the first token where two [B, T] streams differ,
    or None."""
    for lane in range(a.shape[0]):
        hit = np.flatnonzero(a[lane] != b[lane])
        if hit.size:
            return lane, int(hit[0])
    return None


@pytest.mark.parametrize("arm", ["sp", "sp-tp"])
def test_serve_step_tokens_match_reference(runs, arm):
    """Every rank's greedy stream (and the single-process mesh's) equals
    the reference's sequence-parallel stream token for token, up to the
    pinned parting; the ranks' streams are one stream."""
    ref, ranks, local = runs
    want = ref[f"serve/{arm}"]
    for res in ranks[1:]:
        np.testing.assert_array_equal(res[f"serve/{arm}"],
                                      ranks[0][f"serve/{arm}"])
    for got in (ranks[0][f"serve/{arm}"], local[f"serve/{arm}"]):
        assert _first_parting(got, want) == PARTED


def test_parting_from_reference_is_rounding(runs):
    """Where the streams part, the single-device decode of both sides
    parts too, at the same token, and each side's sequence-parallel choice
    there is its own single-device choice: the parting is not the
    sequence-parallel path's. It starts in the prefill the two sides share
    up to rounding: layer 0's int8 K/V bitwise, its f32 scales apart by
    ulps (one requantization of values that differ in their last bits),
    the first int8 flips in layer 1, by one."""
    ref, _, local = runs
    lane, tok = PARTED
    assert _first_parting(local["serve/single"], ref["serve/single"]) == \
        PARTED
    for side in (ref, local):
        assert side["serve/sp"][lane, tok] == side["serve/single"][lane, tok]
    for k in ("k", "v"):
        np.testing.assert_array_equal(local[f"prefill/{k}"][0],
                                      ref[f"prefill/{k}"][0])
    for k in ("k_scale", "v_scale"):
        a, b = local[f"prefill/{k}"][0], ref[f"prefill/{k}"][0]
        assert not np.array_equal(a, b)
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)
    flips = [np.abs(local[f"prefill/{k}"][1].astype(np.int32)
                    - ref[f"prefill/{k}"][1]) for k in ("k", "v")]
    assert max(int(f.max()) for f in flips) == 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--reference"]:
        _reference(sys.argv[2])
