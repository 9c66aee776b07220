"""The port's tile autotuner (``repro_torch/kernels/autotune.py``) on the
CPU: the cases of ``tests/test_autotune.py`` that mean something without a
card, on the port's own knob space, and the shape log held against the
reference's.

  1. ``candidates()`` emits legal, unique candidates within the card's
     shared memory, candidate 0 the default (every knob 0: the kernels'
     own plan), capped by ``max_candidates``;
  2. ``lookup()`` precedence: override → table entry under the card's
     key (``REPRO_TORCH_TUNE=0`` turns it off) → ``{}``; an illegal
     override or a stale entry falls through to ``{}``;
  3. ``validate_table()`` flags structural problems; a missing table is
     fine, and ``--check`` exits 0 without one;
  4. the shape log (dedupe, union across restarts, the environment off by
     default, ``merged_shapes``) in the reference's JSON layout, fed by
     ``ops``' dispatch; a reduced bitnet-3b ``PooledEngine(shape_log=...)``
     logs the same shape set as the reference's on the same weights and
     requests.

``config_key()`` names a CUDA card and raises without one, so the lookup
cases patch it with a card's key. The sweep itself (timing, the bitwise
check of every candidate) needs the card: ``tests/test_torch_gpu.py``
and ``chip_smoke.py`` phase 6.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.bitnet_3b import REDUCED as JCFG
from repro.kernels import autotune as jtune
from repro.serving.api import PooledEngine as JEngine
from repro.serving.scheduler import Request as JRequest
from repro.serving.scheduler import Scheduler as JScheduler
from repro_torch.analysis.roofline import smem_budget
from repro_torch.configs import get_config
from repro_torch.core.ternary import TernaryWeight
from repro_torch.kernels import autotune, ops
from repro_torch.serving.api import GenerateRequest, PooledEngine
from repro_torch.serving.quantize import init_serving_params
from repro_torch.serving.scheduler import Scheduler

torch.set_num_threads(1)

KEY = "cuda:NVIDIA H100 80GB HBM3:sm_90"
DIMS = {
    "ternary_matmul": {"m": 8, "k": 256, "n": 256},
    "qlinear": {"e": 2, "m": 8, "k": 256, "n": 256},
    "ffn": {"e": 1, "m": 8, "k": 256, "f": 512, "n": 256},
    "prefill": {"bhg": 2, "r": 64, "d": 64, "m": 256, "chunk": 32},
    "decode": {"bhg": 2, "g": 2, "d": 64, "m": 256, "block": 64,
               "k_keep": 2},
}
FULL = {k: v[-1] for k, v in autotune.DEFAULT_SHAPES.items()}
CASES = ([(k, d) for k, d in DIMS.items()]
         + [(k, d) for k, d in FULL.items()])


@pytest.fixture(autouse=True)
def _no_log_or_table(monkeypatch, tmp_path):
    """Every case starts with no shape log armed and no table in reach."""
    for env in (autotune.SHAPE_LOG_ENV, autotune.TUNE_ENV):
        monkeypatch.delenv(env, raising=False)
    monkeypatch.setenv(autotune.TABLE_ENV, str(tmp_path / "absent.json"))
    autotune.stop_shape_log()
    yield
    autotune.stop_shape_log()


# ---------------------------------------------------------------------------
# Candidate generation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel,d", CASES,
                         ids=[f"{k}-{autotune.shape_key(k, d)}"
                              for k, d in CASES])
def test_candidates_legal_unique_within_budget(kernel, d):
    cands = autotune.candidates(kernel, d, max_candidates=12)
    assert 1 <= len(cands) <= 12
    seen = []
    for p in cands:
        assert set(p) == set(autotune.KERNEL_PARAMS[kernel]), p
        assert autotune.valid_params(kernel, d, p), p
        assert p not in seen, p
        seen.append(p)
    if kernel == "decode":
        for p in cands:
            assert autotune.decode_smem(d, p["stages"] or 2) <= smem_budget()
    elif kernel != "prefill":
        for p in cands:
            tile = p["tile"] or (16 if d["m"] <= 16 else 128)
            assert autotune.TILE_SMEM[tile] <= smem_budget()


def test_candidate_zero_is_the_default():
    """The sweep always times the kernels' own plan first."""
    assert autotune.candidates("qlinear", DIMS["qlinear"])[0] == \
        {"split": 0, "tile": 0}
    assert autotune.candidates("ffn", DIMS["ffn"])[0] == \
        {"split_gu": 0, "split_down": 0, "tile": 0}
    assert autotune.candidates("decode", FULL["decode"]) == \
        [{"stages": 0}, {"stages": 4}, {"stages": 3}]
    assert autotune.candidates("prefill", DIMS["prefill"]) == [{}]


def test_max_candidates_caps_the_sweep():
    assert len(autotune.candidates("ffn", FULL["ffn"], max_candidates=3)) == 3
    assert len(autotune.candidates("qlinear", FULL["qlinear"],
                                   max_candidates=6)) == 6


def test_decode_smem_is_the_kernels_layout():
    """The restated layout gives the launch's dynamic shared memory that
    the card reported at bitnet-3b's decode shape (PERF.md §6: 27,040 B
    LOP, 26,736 B dense at two stages)."""
    d = FULL["decode"]
    assert autotune.decode_smem(d, 2) == 27040
    assert autotune.decode_smem(d, 2, lop=False) == 26736
    assert autotune.decode_smem(d, 3) == 27040 + 13312
    assert autotune.decode_smem(d, 4) == 27040 + 2 * 13312


def test_planner_model_of_the_default_split():
    """The static model plans the split as the tile core does: the
    largest cluster whose CTAs are all resident at once (k split 8 for
    bitnet-3b's QKV at m 4, 3 at m 128)."""
    assert autotune._gemm_plan(4, 3200, 9600, 0, 0)["split"] == 8
    assert autotune._gemm_plan(128, 3200, 9600, 0, 0)["split"] == 3
    assert autotune._gemm_plan(128, 3200, 9600, 0, 0)["tile"] == 128
    assert autotune._gemm_plan(4, 3200, 9600, 2, 128)["ctas"] == 150
    # the rest of what the card planned at bitnet-3b's shapes (phase 3 of
    # chip_smoke.py): O k split 8 at m 4 and 128; the FFN's gate‖up (128
    # registers a thread: 4 CTAs an SM) 3 at m 4, 1 at m 128
    assert autotune._gemm_plan(4, 3200, 3200, 0, 0)["split"] == 8
    assert autotune._gemm_plan(128, 3200, 3200, 0, 0)["split"] == 8
    assert autotune._gemm_plan(4, 3200, 8640, 0, 0, paired=True)["split"] == 3
    assert autotune._gemm_plan(128, 3200, 8640, 0, 0,
                               paired=True)["split"] == 1


# ---------------------------------------------------------------------------
# Keys and the legality screen
# ---------------------------------------------------------------------------

def test_shape_key_uses_declared_dim_order():
    key = autotune.shape_key("qlinear", {"n": 4, "k": 3, "m": 2, "e": 1})
    assert key == "e=1,m=2,k=3,n=4"
    assert key == jtune.shape_key("qlinear", {"n": 4, "k": 3, "m": 2, "e": 1})
    with pytest.raises(AssertionError):
        autotune.shape_key("qlinear", {"m": 2})
    assert autotune.KERNEL_DIMS == jtune.KERNEL_DIMS


def test_config_key_names_the_card(monkeypatch):
    autotune._device_key.cache_clear()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        autotune.config_key()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda i=0: (9, 0))
    try:
        assert autotune.config_key() == KEY
    finally:
        autotune._device_key.cache_clear()


def test_sweep_on_the_cpu_raises(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA card"):
        autotune.run_sweep(["qlinear"], out_path=tmp_path / "t.json",
                           log=None)
    assert not (tmp_path / "t.json").exists()


@pytest.mark.parametrize("kernel,params,ok", [
    ("qlinear", {"split": 8, "tile": 16}, True),    # k 1024: 8 k-stages
    ("qlinear", {"split": 0, "tile": 0}, True),
    ("qlinear", {"split": 9}, False),               # past the cluster cap
    ("qlinear", {"split": -1}, False),
    ("qlinear", {"tile": 64}, False),               # no 64-row tile
    ("qlinear", {"nope": 1}, False),                # unknown knob
    ("qlinear", "split=8", False),                  # not a dict
    ("qlinear", {"split": "x"}, False),
    ("ffn", {"split_gu": 2, "split_down": 4, "tile": 128}, True),
    ("ffn", {"split_gu": 3}, False),                # k 256: 2 k-stages
    ("ffn", {"split_down": 5}, False),              # f 512: 4 k-stages
    ("prefill", {}, True),
    ("prefill", {"block": 32}, False),              # no knob to set
    ("decode", {"stages": 4}, True),
    ("decode", {"stages": 0}, True),
    ("decode", {"stages": 1}, False),
    ("decode", {"stages": 5}, False),
    ("ternary_matmul", {"split": 2, "tile": 16}, True),
    ("ternary_matmul", {"split": 3}, False),        # k 256: 2 k-stages
])
def test_valid_params_screen(kernel, params, ok):
    dims = dict(DIMS[kernel], **({"k": 1024} if kernel == "qlinear" else {}))
    assert autotune.valid_params(kernel, dims, params) is ok


def test_decode_stages_past_the_shared_memory_are_illegal():
    big = dict(FULL["decode"], d=256, block=256)
    assert autotune.decode_smem(big, 4) > smem_budget()
    assert not autotune.valid_params("decode", big, {"stages": 4})
    assert {"stages": 4} not in autotune.candidates("decode", big)


# ---------------------------------------------------------------------------
# Table I/O + lookup precedence
# ---------------------------------------------------------------------------

QDIMS = {"e": 1, "m": 8, "k": 512, "n": 64}


def _mk_table(tmp_path, monkeypatch, params, *, ms=0.01):
    path = tmp_path / "TUNE_test.json"
    monkeypatch.setenv(autotune.TABLE_ENV, str(path))
    monkeypatch.setattr(autotune, "config_key", lambda: KEY)
    table = {"version": autotune.TABLE_VERSION,
             "configs": {KEY: {"qlinear": {
                 autotune.shape_key("qlinear", QDIMS):
                     {"params": params, "ms": ms}}}}}
    autotune.save_table(table, path)
    return path


def test_lookup_hits_table_misses_other_shapes(tmp_path, monkeypatch):
    _mk_table(tmp_path, monkeypatch, {"split": 4, "tile": 128})
    assert autotune.lookup("qlinear", QDIMS) == {"split": 4, "tile": 128}
    assert autotune.lookup("qlinear", dict(QDIMS, m=16)) == {}
    assert autotune.lookup("ffn", DIMS["ffn"]) == {}


def test_table_of_another_card_is_not_read(tmp_path, monkeypatch):
    _mk_table(tmp_path, monkeypatch, {"split": 4})
    monkeypatch.setattr(autotune, "config_key",
                        lambda: "cuda:NVIDIA H200:sm_90")
    assert autotune.lookup("qlinear", QDIMS) == {}


def test_repro_torch_tune_0_disables_the_table(tmp_path, monkeypatch):
    _mk_table(tmp_path, monkeypatch, {"split": 2})
    monkeypatch.setenv(autotune.TUNE_ENV, "0")
    assert autotune.lookup("qlinear", QDIMS) == {}
    # the reference's switch steers the reference alone
    monkeypatch.delenv(autotune.TUNE_ENV)
    monkeypatch.setenv("REPRO_TUNE", "0")
    assert autotune.lookup("qlinear", QDIMS) == {"split": 2}


def test_override_beats_table_and_restores(tmp_path, monkeypatch):
    _mk_table(tmp_path, monkeypatch, {"split": 2})
    with autotune.override("qlinear", split=4, tile=16):
        assert autotune.lookup("qlinear", QDIMS) == {"split": 4, "tile": 16}
        with autotune.override("qlinear", tile=128):
            assert autotune.lookup("qlinear", QDIMS) == {"tile": 128}
        assert autotune.lookup("qlinear", QDIMS) == {"split": 4, "tile": 16}
    assert autotune.lookup("qlinear", QDIMS) == {"split": 2}


def test_illegal_override_falls_through_to_defaults():
    with autotune.override("qlinear", split=8):     # k 512: 4 k-stages
        assert autotune.lookup("qlinear", QDIMS) == {}
    with autotune.override("decode", stages=7):
        assert autotune.lookup("decode", FULL["decode"]) == {}


def test_stale_table_entry_falls_through_and_is_flagged(tmp_path,
                                                        monkeypatch):
    path = _mk_table(tmp_path, monkeypatch, {"tile": 64})
    assert autotune.lookup("qlinear", QDIMS) == {}
    problems = autotune.validate_table(path)
    assert len(problems) == 1 and "illegal params" in problems[0]


def test_load_table_missing_and_reload_on_save(tmp_path):
    path = tmp_path / "TUNE_x.json"
    assert autotune.load_table(path) == {}
    t1 = {"version": 1, "configs": {}}
    autotune.save_table(t1, path)
    assert autotune.load_table(path) == t1
    t2 = {"version": 1, "configs": {KEY: {}}}
    autotune.save_table(t2, path)
    assert autotune.load_table(path) == t2
    path.write_text("{not json")
    assert autotune.load_table(path) == {}


def test_validate_table_structural_problems(tmp_path):
    assert autotune.validate_table(tmp_path / "absent.json") == []
    path = tmp_path / "TUNE_bad.json"
    path.write_text("{not json")
    assert len(autotune.validate_table(path)) == 1
    bad = {"version": 99, "configs": {KEY: {
        "nope": {"m=8": {"params": {}}},
        "qlinear": {
            "m=x": {"params": {}},                        # unparseable key
            "m=8": {"params": {}},                        # wrong dims
            "e=1,m=8,k=64,n=64": {"params": {"split": 7}},  # illegal
        }}}}
    path.write_text(json.dumps(bad))
    problems = autotune.validate_table(path)
    assert len(problems) == 5
    joined = "\n".join(problems)
    for frag in ("version", "unknown kernel", "bad shape key", "dims !=",
                 "illegal params"):
        assert frag in joined, frag


def test_check_passes_without_a_table(tmp_path, capsys):
    assert autotune.main(["--check", "--out",
                          str(tmp_path / "absent.json")]) == 0
    assert "table OK" in capsys.readouterr().out
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"version": 1, "configs": {KEY: {
        "decode": {"bhg=1,g=1,d=64,m=256,block=64,k_keep=2":
                   {"params": {"stages": 9}}}}}}))
    assert autotune.main(["--check", "--out", str(bad)]) == 1


# ---------------------------------------------------------------------------
# Shape log: dispatch shapes → JSON → the --from-log sweep set
# ---------------------------------------------------------------------------

def test_shape_log_records_dedupes_and_loads(tmp_path):
    path = tmp_path / "shapes.json"
    autotune.start_shape_log(path)
    dims = {"m": 8, "k": 64, "n": 128}
    autotune.observe("ternary_matmul", dims)
    autotune.observe("ternary_matmul", dims)              # deduplicated
    autotune.observe("qlinear", {"e": 1, "m": 4, "k": 64, "n": 64})
    autotune.observe("not_a_kernel", {"m": 1})            # unknown: no-op
    autotune.stop_shape_log()
    raw = json.loads(path.read_text())
    assert raw["version"] == autotune.SHAPE_LOG_VERSION
    assert raw["shapes"]["ternary_matmul"] == [
        autotune.shape_key("ternary_matmul", dims)]
    loaded = autotune.load_shape_log(path)
    assert loaded == {"ternary_matmul": [dims],
                      "qlinear": [{"e": 1, "m": 4, "k": 64, "n": 64}]}
    # the reference reads the port's log, key for key
    assert jtune.load_shape_log(path) == loaded


def test_shape_log_survives_restart_and_unions(tmp_path):
    path = tmp_path / "shapes.json"
    autotune.start_shape_log(path)
    autotune.observe("ternary_matmul", {"m": 8, "k": 64, "n": 128})
    autotune.stop_shape_log()
    autotune.start_shape_log(path)
    autotune.observe("ternary_matmul", {"m": 8, "k": 64, "n": 128})
    autotune.observe("ternary_matmul", {"m": 16, "k": 64, "n": 128})
    autotune.stop_shape_log()
    loaded = autotune.load_shape_log(path)["ternary_matmul"]
    assert len(loaded) == 2
    assert {"m": 8, "k": 64, "n": 128} in loaded
    assert {"m": 16, "k": 64, "n": 128} in loaded


def test_merged_shapes_grows_defaults_without_duplicates(tmp_path):
    path = tmp_path / "shapes.json"
    autotune.start_shape_log(path)
    known = autotune.DEFAULT_SHAPES["qlinear"][0]
    novel = {"e": 1, "m": 48, "k": 3200, "n": 9600}
    assert novel not in autotune.DEFAULT_SHAPES["qlinear"]
    autotune.observe("qlinear", known)                   # already swept
    autotune.observe("qlinear", novel)
    autotune.observe("prefill", DIMS["prefill"])
    autotune.stop_shape_log()
    merged = autotune.merged_shapes(path)
    base = autotune.DEFAULT_SHAPES["qlinear"]
    assert merged["qlinear"][:len(base)] == base
    assert merged["qlinear"].count(known) == 1
    assert novel in merged["qlinear"]
    assert merged["prefill"] == [DIMS["prefill"]]


def test_shape_log_env_off_by_default(tmp_path, monkeypatch):
    assert autotune.shape_log_path() is None
    monkeypatch.setenv(autotune.SHAPE_LOG_ENV, "0")
    assert autotune.shape_log_path() is None
    monkeypatch.setenv(autotune.SHAPE_LOG_ENV, "1")
    assert autotune.shape_log_path() == autotune.DEFAULT_SHAPE_LOG
    monkeypatch.setenv(autotune.SHAPE_LOG_ENV, str(tmp_path / "s.json"))
    assert autotune.shape_log_path() == tmp_path / "s.json"
    # the reference's variable steers the reference alone
    monkeypatch.delenv(autotune.SHAPE_LOG_ENV)
    monkeypatch.setenv("REPRO_SHAPE_LOG", str(tmp_path / "r.json"))
    assert autotune.shape_log_path() is None


def test_ops_dispatch_feeds_the_shape_log(tmp_path):
    """Every entry of the five tuned kernels lands its dims in the log on
    the CPU as on the card, under the reference's names."""
    path = tmp_path / "shapes.json"
    rng = np.random.default_rng(5)
    k, n, f = 64, 48, 32
    packed = torch.from_numpy(rng.integers(0, 256, (k // 4, n), np.uint8))
    tw = TernaryWeight(packed=packed, scale=torch.tensor(0.02),
                       shape=(k, n))
    xq = torch.from_numpy(rng.integers(-127, 128, (2, 4, k), np.int8))
    x = torch.from_numpy(rng.standard_normal((5, k)).astype(np.float32))
    gu = torch.from_numpy(rng.integers(0, 256, (k // 4, 2 * f), np.uint8))
    dn = torch.from_numpy(rng.integers(0, 256, (f // 4, n), np.uint8))
    one = torch.ones(1, 1)
    b, hkv, g, m, dh, blk = 2, 2, 2, 64, 32, 32
    qi = torch.from_numpy(rng.integers(-127, 128, (b, hkv * g, dh), np.int8))
    qsc = torch.full((b, hkv * g, 1), 0.01)
    kv = torch.from_numpy(rng.integers(-127, 128, (b, hkv, m, dh), np.int8))
    sc = torch.full((b, hkv, m), 0.01)
    feat = torch.from_numpy(rng.integers(0, 256, (b, hkv, m, dh // 2),
                                         np.uint8))
    autotune.start_shape_log(path)
    ops.ternary_matmul(xq, tw)
    ops.qlinear_fused(x, packed, one)
    ops.ffn_fused(x, gu, one, dn, one, gated=True, act="silu")
    ops.prefill_attention(qi[:, :, None].expand(b, hkv * g, 8, dh)
                          .contiguous(), qsc.expand(b, hkv * g, 8),
                          kv, kv, sc, sc, torch.tensor([8, 8]))
    ops.decode_attention(qi, qsc, kv, kv, sc, sc, feat,
                         torch.tensor([40, 64]), block=blk, k_keep=1)
    autotune.stop_shape_log()
    loaded = autotune.load_shape_log(path)
    assert loaded == {
        "ternary_matmul": [{"m": 8, "k": k, "n": n}],
        "qlinear": [{"e": 1, "m": 5, "k": k, "n": n}],
        "ffn": [{"e": 1, "m": 5, "k": k, "f": f, "n": n}],
        "prefill": [{"bhg": b * hkv, "r": g * 8, "d": dh, "m": m,
                     "chunk": 8}],
        "decode": [{"bhg": b * hkv, "g": g, "d": dh, "m": m, "block": blk,
                    "k_keep": 1}]}


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree.numpy())


def test_engine_logs_the_reference_shape_set(tmp_path):
    """A reduced bitnet-3b served by the port's ``PooledEngine(shape_log=
    ...)`` logs the same kernel shapes as the reference's engine on the
    same weights and requests (chunked prefill, LOP decode, two lanes)."""
    cfg = get_config("bitnet-3b-reduced")
    qp = init_serving_params(cfg, 0, torch.device("cpu"))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
               for n in (9, 33, 45)]
    ours, theirs = tmp_path / "port.json", tmp_path / "reference.json"
    sched = Scheduler(PooledEngine(cfg, qp, max_len=63, device="cpu",
                                   shape_log=str(ours)), n_slots=2)
    for rid, p in enumerate(prompts):
        sched.submit(GenerateRequest(rid=rid, prompt=p, max_new_tokens=3))
    sched.run_to_completion()
    autotune.stop_shape_log()
    jqp = _to_jax(qp)
    try:
        jsched = JScheduler(JCFG, jqp, n_slots=2, max_len=63,
                            engine=JEngine(JCFG, jqp, max_len=63,
                                           shape_log=str(theirs)))
        for rid, p in enumerate(prompts):
            jsched.submit(JRequest(rid=rid, prompt=p, max_new_tokens=3))
        jsched.run_to_completion()
    finally:
        jtune.stop_shape_log()
    got, want = json.loads(ours.read_text()), json.loads(theirs.read_text())
    assert got == want
    assert set(got["shapes"]) == {"qlinear", "ffn", "prefill", "decode"}
