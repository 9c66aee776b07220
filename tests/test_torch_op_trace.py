"""The meta-device trace (``repro_torch.analysis.op_trace``, the
counterpart of the reference's ``analysis/hlo.py``), the abstract mesh's
collectives and the kernel entries' meta branch, held against the
reference where it has a counterpart:

  * ``hbm_bytes`` on the cases of ``tests/test_hlo_analysis.py``: a
    matmul chain counts its operands and results, bare elementwise ops
    count as fused, an in-place cache-row write counts its update only;
  * ``collective_bytes`` on the collective mix of the reference's
    ``test_collective_bytes_parser``, through the abstract mesh;
  * each of the six collectives on an abstract mesh returns the shape and
    dtype one rank gets on ``local_mesh``; the abstract mesh takes meta
    tensors only;
  * the memory model: arguments, temporaries freed in order, the peak,
    outputs and a donated argument updated in place (aliased);
  * the kernel records of one meta decode step of reduced bitnet-3b (2·L
    #1, L #2, L #4; L #5 at ``use_lop=False``) and of a training step
    (none); the same step on the CPU returns the meta trace's shapes and
    dtypes; a meta tensor with no trace raises;
  * ``kernel_cost`` at the main path's shapes against the bounds'
    formulas; the traced replay of identical scan chunks and steps and of
    microbatches against the full trace.
"""
import pytest
import torch

from repro.analysis.hlo import collective_bytes as jcollective_bytes
from repro_torch.analysis.op_trace import (ALLOC_ROUND, OpTrace,
                                           collective_bytes, hbm_bytes)
from repro_torch.analysis.roofline import kernel_cost
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import partitioning as P
from repro_torch.kernels import ops
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import abstract_mesh, local_mesh
from repro_torch.models import scan_utils
from repro_torch.serving.cache import init_cache_pool
from repro_torch.serving.engine import serve_step
from repro_torch.serving.quantize import init_serving_params
from repro_torch.training import train as T
from repro_torch.tree_util import flatten_with_path

torch.set_num_threads(1)


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# the fused-HBM model (tests/test_hlo_analysis.py's cases)
# ---------------------------------------------------------------------------

def test_hbm_model_counts_matmuls_not_elementwise():
    p0, c = meta(128, 64), meta(64, 32)
    with OpTrace() as tr:
        fused = p0 * p0 + p0 * p0          # bare elementwise: fused
        y = torch.exp(fused @ c)           # a dot, then elementwise
    dot = 128 * 64 * 4 + 64 * 32 * 4 + 128 * 32 * 4
    assert hbm_bytes(tr) == dot
    assert y.shape == (128, 32)
    # raw bytes count every op's operands and result
    ew = 3 * (128 * 64 * 4 * 3)
    assert tr.bytes == ew + dot + 2 * 128 * 32 * 4
    assert tr.flops == 2 * 128 * 64 * 32


def test_hbm_model_in_place_cache_row_write():
    cache = meta(4, 1024, 128, dtype=torch.int8)
    upd = meta(4, 128, dtype=torch.int8)
    lanes = meta(4, dtype=torch.int64)
    pos = meta(4, dtype=torch.int64)
    with OpTrace() as tr:
        cache[lanes, pos] = upd            # index_put_: in place
        cache[:, 7:8] = upd[:, None]       # a slice write: copy_
    # the update (and its indices) only, never the 512 KiB buffer
    assert hbm_bytes(tr) == (4 * 128 + 2 * 4 * 8) + 4 * 128


# ---------------------------------------------------------------------------
# collectives of the abstract mesh
# ---------------------------------------------------------------------------

def test_collective_bytes_reference_mix():
    hlo = """
  %ag = f32[8,128]{1,0} all-gather(%x), replica_groups=...
  %ar.1 = bf16[64]{0} all-reduce(%y), to_apply=%sum
  %cp = (s8[4,4]{1,0}, u32[]) collective-permute-start(%z)
  %cpd = s8[4,4]{1,0} collective-permute-done(%cp)
  %rs = f32[16]{0} reduce-scatter(%w), dimensions={0}
  %a2a = f32[2,8]{1,0} all-to-all(%v), dimensions={0}
"""
    want = jcollective_bytes(hlo)
    mesh = abstract_mesh((2, 4), ("data", "model"))
    with OpTrace() as tr:
        P.all_gather(meta(2, 128), "model", 0, mesh)          # f32[8,128]
        P.psum(meta(64, dtype=torch.bfloat16), "model", mesh)  # bf16[64]
        P.ppermute(meta(4, 4, dtype=torch.int8), "model", mesh)
        P.psum_scatter(meta(64), "model", 0, mesh)             # f32[16]
        P.all_to_all(meta(4, 2, 2), "model", 0, 2, mesh)       # [2,2,4]
    got = collective_bytes(tr)
    # XLA's async permute carries a u32[] context beside its s8[4,4]
    # result, which a collective of the port does not
    want["collective-permute"] -= 4
    want["total"] -= 4
    assert got == want


LOCAL = (2, 4)


@pytest.mark.parametrize("op", ["psum", "pmax", "psum_scatter",
                                "all_gather", "all_to_all", "ppermute"])
def test_abstract_collectives_match_local_mesh_shapes(op):
    """What one rank receives, by shape and dtype: the abstract mesh's
    result against a rank's slice of the single-process mesh's."""
    axes = ("data", "model")
    lm, am = local_mesh(LOCAL, axes), abstract_mesh(LOCAL, axes)
    shape = (4, 8, 6)

    def call(x, mesh):
        return {"psum": lambda: P.psum(x, "model", mesh),
                "pmax": lambda: P.pmax(x, ("data", "model"), mesh),
                "psum_scatter": lambda: P.psum_scatter(x, "model", 1, mesh),
                "all_gather": lambda: P.all_gather(x, ("data", "model"), 2,
                                                   mesh),
                "all_to_all": lambda: P.all_to_all(x, "model", 0, 2, mesh),
                "ppermute": lambda: P.ppermute(x, "model", mesh)}[op]()
    whole = torch.randn((*LOCAL, *shape), dtype=torch.float64)
    rank = call(whole, lm)[0, 0]           # rank (0, 0)'s value
    got = call(meta(*shape, dtype=torch.float64), am)
    assert got.device.type == "meta"
    assert (got.shape, got.dtype) == (rank.shape, rank.dtype)


def test_abstract_mesh_is_one_rank_of_meta_tensors():
    mesh = abstract_mesh((16, 16), ("data", "model"), {"data": 3,
                                                       "model": 5})
    assert not mesh.local and mesh.abstract
    assert mesh.coords() == {"data": 3, "model": 5}
    assert mesh.rank(("data", "model")) == 3 * 16 + 5
    with pytest.raises(ValueError, match="meta tensors only"):
        P.psum(torch.zeros(4), "model", mesh)
    # a size-1 axis moves nothing and records nothing
    one = abstract_mesh((1, 4), ("data", "model"))
    with OpTrace() as tr:
        P.psum(meta(3), "data", one)
    assert collective_bytes(tr)["total"] == 0


# ---------------------------------------------------------------------------
# the memory model
# ---------------------------------------------------------------------------

def test_memory_model_tracks_live_bytes():
    a = meta(1000)                          # 4000 B argument
    tr = OpTrace()
    tr.arguments(a)
    with tr:
        b = a * 2                           # 4096 (rounded) live
        c = b + 1                           # 8192 live: the peak
        del b                               # 4096
        d = c * 3                           # 8192
        del c                               # 4096
        a.add_(1)                           # in place: no allocation
    mem = tr.memory((a, d))
    assert ALLOC_ROUND == 512
    assert tr.peak_temp_bytes == 8192
    assert mem == {"argument_bytes": 4000, "output_bytes": 8000,
                   "alias_bytes": 4000, "temp_bytes": 8192 - 4000,
                   "peak_estimate_bytes": 4000 + 8192}


# ---------------------------------------------------------------------------
# the kernel entries on meta tensors
# ---------------------------------------------------------------------------

CFG = get_config("bitnet-3b-reduced")


@pytest.mark.parametrize("use_lop", [True, False])
def test_meta_decode_step_records_kernels(use_lop):
    b, max_len = 2, 63
    qp = init_serving_params(CFG, 0, "meta")
    pool = init_cache_pool(CFG, b, max_len, "meta")
    tokens = meta(b, 1, dtype=torch.int64)
    tr = OpTrace()
    tr.arguments(qp, pool, tokens)
    with tr:
        logits, _ = serve_step(CFG, qp, pool, tokens, use_lop=use_lop)
    n = CFG.n_layers
    decode = "fused_decode_attention" if use_lop else \
        "fused_dense_decode_attention"
    assert tr.kernels == {"fused_qlinear": 2 * n, "fused_ffn": n, decode: n}
    # the same step on the CPU through the plain versions: the trace's
    # shapes and dtypes
    qc = init_serving_params(CFG, 0, "cpu")
    pc = init_cache_pool(CFG, b, max_len, "cpu")
    pc["active"].fill_(True)
    ops.reset_launch_counts()
    got, pc = serve_step(CFG, qc, pc, torch.tensor([[3], [5]]),
                         use_lop=use_lop)
    assert (got.shape, got.dtype) == (logits.shape, logits.dtype)
    assert [(p, x.shape, x.dtype) for p, x in flatten_with_path(pc)] == \
        [(p, x.shape, x.dtype) for p, x in flatten_with_path(pool)]
    # the argument bytes are the trees' nbytes
    assert tr.argument_bytes() == sum(
        x.numel() * x.element_size() for t in (qc, pc)
        for _, x in flatten_with_path(t)) + 2 * 8


def test_training_step_records_no_kernel():
    r = D.run_cell("bitnet-3b-reduced", "train_4k",
                   shape=ShapeConfig("train_4k", 32, 2, "train"), n_micro=1,
                   differential=False, verbose=False)
    assert r["raw_scan_cost"]["kernels"] == {}


def test_meta_tensor_without_a_trace_raises():
    x, packed, scale = meta(4, 128), meta(32, 64, dtype=torch.uint8), \
        meta(1, 1)
    with pytest.raises(ValueError, match="meta"):
        ops.qlinear_fused(x, packed, scale)
    with OpTrace() as tr:
        y = ops.qlinear_fused(x, packed, scale)
    assert (y.shape, y.dtype, y.device.type) == ((4, 64), torch.float32,
                                                  "meta")
    assert tr.kernels == {"fused_qlinear": 1}
    assert tr.kernel_bytes == kernel_cost("fused_qlinear", m=4, k=128,
                                          n=64)["bytes"]


# ---------------------------------------------------------------------------
# kernel_cost at the main path's shapes (bitnet-3b: d 3200, 32 heads of
# 100, ffn 8640, capacity 1664, block 128): what the bounds count
# ---------------------------------------------------------------------------

def test_kernel_cost_counts_what_the_bounds_count():
    d, f, h, dh, blk = 3200, 8640, 32, 100, 128
    for m, n in ((4, 3 * d), (128, d)):
        c = kernel_cost("fused_qlinear", m=m, k=d, n=n)
        assert c == {"bytes": m * d * 4 + d // 4 * n + n * 4 + m * n * 4,
                     "int8_ops": 2 * m * d * n, "flops": 0}
    c = kernel_cost("fused_ffn", m=4, k=d, f=f, n=d)
    assert c["bytes"] == (4 * d * 4 + d // 4 * 2 * f + 2 * f * 4
                          + f // 4 * d + d * 4 + 4 * d * 4)
    assert c["int8_ops"] == 2 * 4 * d * 2 * f + 2 * 4 * f * d
    r, q_off = 128, 1408
    c = kernel_cost("fused_prefill_attention", b=1, h=h, hkv=h, c=r, dh=dh,
                    kvl=q_off + r, q_off=q_off)
    pairs = sum(q_off + i + 1 for i in range(r))
    assert c == {"bytes": h * r * (dh + 4) + h * (q_off + r) * (2 * dh + 8)
                 + h * r * dh * 4, "int8_ops": 2 * h * pairs * dh,
                 "flops": 2 * h * pairs * dh}
    nl = [1600, 0, 700, 1200]
    c = kernel_cost("fused_decode_attention", b=4, h=h, hkv=h, dh=dh,
                    block=blk, k_keep=2, new_len=nl)
    sel = sum(min(2, -(-n // blk)) for n in nl if n)
    live = sum(min(n, 2 * blk) for n in nl if n)
    assert c == {"bytes": 4 * h * (dh + 4) + 16 + h * sum(nl) * (dh // 2)
                 + h * sel * blk * (2 * dh + 8) + 4 * h * dh * 4,
                 "int8_ops": 2 * h * (sum(nl) + live) * dh,
                 "flops": 2 * h * live * dh}
    c = kernel_cost("fused_dense_decode_attention", b=4, h=h, hkv=h, dh=dh,
                    block=blk, new_len=nl)
    assert c["bytes"] == (4 * h * (dh + 4) + 16 + h * sum(nl) * (2 * dh + 8)
                          + 4 * h * dh * 4)


# ---------------------------------------------------------------------------
# the traced replays against the full trace
# ---------------------------------------------------------------------------

def _cell(arch, shape, n_micro=1):
    tr, out, _, _ = D._build_and_trace(get_config(arch), shape,
                                       D.make_production_mesh(),
                                       n_micro=n_micro)
    return (tr.flops, tr.bytes, tr.hbm, sum(tr.collectives.values()),
            tr.memory(out)["peak_estimate_bytes"])


@pytest.mark.parametrize("arch,kind", [("rwkv6-1.6b-reduced", "train"),
                                       ("rwkv6-1.6b-reduced", "prefill"),
                                       ("jamba-1.5-large-398b-reduced",
                                        "prefill")])
def test_scan_replay_agrees_with_the_full_trace(monkeypatch, arch, kind):
    """Three chunks of 64 steps: the replayed chunks (and Mamba's replayed
    steps) cost what the traced ones do — FLOPs, collectives exact; raw
    and fused bytes within 0.2 %; the peak within 7 % (the measurement's
    own transients)."""
    shape = ShapeConfig(f"{kind}_x", 192, 1, kind)
    got = _cell(arch, shape)
    monkeypatch.setattr(scan_utils, "_tracing", lambda *a, **k: None)
    want = _cell(arch, shape)
    assert got[0] == want[0] and got[3] == want[3]
    for g, w, tol in zip(got[1:3] + got[4:], want[1:3] + want[4:],
                         (2e-3, 2e-3, 0.07)):
        assert abs(g / w - 1) <= tol, (got, want)


def test_microbatch_replay_is_exact(monkeypatch):
    shape = ShapeConfig("train_x", 32, 64, "train")
    got = _cell("bitnet-3b-reduced", shape, n_micro=4)
    monkeypatch.setattr(T, "_tracing", lambda *a: None)
    want = _cell("bitnet-3b-reduced", shape, n_micro=4)
    assert got[:4] == want[:4]
    assert abs(got[4] / want[4] - 1) < 0.01
