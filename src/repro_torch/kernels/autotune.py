"""Tile autotuning for the port's Hopper kernels.

The kernels of :mod:`repro_torch.kernels.ops` pick their own launch: the
ternary tile core plans each GEMM's k split from what the card holds
(``csrc/ternary_tile.cuh``), the projection takes a 16- or 128-row tile
by m, and the decode kernels run a two-stage ``cp.async`` ring. This
module makes those choices *swept*: per kernel and per workload shape it
generates candidates (pruned by the card's shared memory and a static
residency model from :mod:`repro_torch.analysis.roofline`), times each on
the card, and keeps the winner in a table keyed by the card that
``ops.py`` consults at dispatch.

Every swept knob is a pure tiling choice, bitwise the default at every
legal setting — the sweep checks each candidate's output against the
default launch on the same inputs and raises on a difference:

  ================  ==========================================  ==========
  kernel            swept parameters (0 = the planner's choice)  why bitwise
  ================  ==========================================  ==========
  ternary_matmul    split (CTAs a tile's k is split over, 1–8),  exact int32
                    tile (rows a tile, 16 or 128)                sums
  qlinear           split, tile                                  same core,
                                                                 same
                                                                 epilogue
  ffn               split_gu, split_down (the two GEMMs), tile   same
  prefill           none (fragment layout fixes the tiles; the   —
                    warp count would change the f32 merge order)
  decode            stages (the ring's depth, 2–4)               fold order
                                                                 unchanged
  ================  ==========================================  ==========

Precedence at dispatch (``lookup``):

  1. an active :func:`override` context (tests, experiments);
  2. the table — ``REPRO_TORCH_TUNE_TABLE`` or the repository's
     ``TUNE_kernels_torch.json`` — under the card's key (:func:`config_key`),
     entries screened against the workload's legality (:func:`valid_params`);
  3. ``{}`` — the planner's choices. With no table (and ``REPRO_TORCH_TUNE=0``
     forces this) every launch is the launch the kernels plan for themselves.

A stale or illegal entry falls through to ``{}``. The shape log
(``start_shape_log`` / ``REPRO_TORCH_SHAPE_LOG``) records every distinct
dispatch shape in the reference's JSON layout, under the reference's
dimension names, so ``--from-log`` sweeps the shapes that traffic served.

    python -m repro_torch.kernels.autotune [--from-log PATH] [--out PATH]
    python -m repro_torch.kernels.autotune --check

A sweep runs only on a CUDA card; on the CPU it raises (there are no
tiles to time). ``ops.py`` imports this module, so it stays import-light:
torch and the kernel wrappers load inside the sweep functions only.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import sys
from pathlib import Path

from repro_torch.analysis.roofline import (SMS, resident_ctas_per_sm,
                                           smem_budget)

ROOT = Path(__file__).resolve().parents[3]
DEFAULT_TABLE = ROOT / "TUNE_kernels_torch.json"
_DEFAULT_TABLE = str(DEFAULT_TABLE)
TABLE_VERSION = 1
TABLE_ENV = "REPRO_TORCH_TUNE_TABLE"
TUNE_ENV = "REPRO_TORCH_TUNE"
DEFAULT_SHAPE_LOG = ROOT / "TUNE_shapes_torch.json"
SHAPE_LOG_ENV = "REPRO_TORCH_SHAPE_LOG"
SHAPE_LOG_VERSION = 1

KERNELS = ("ternary_matmul", "qlinear", "ffn", "prefill", "decode")

# dims each kernel's shape key is built from (the reference's names), and
# the knobs it sweeps
KERNEL_DIMS = {
    "ternary_matmul": ("m", "k", "n"),
    "qlinear": ("e", "m", "k", "n"),
    "ffn": ("e", "m", "k", "f", "n"),
    "prefill": ("bhg", "r", "d", "m", "chunk"),
    "decode": ("bhg", "g", "d", "m", "block", "k_keep"),
}
KERNEL_PARAMS = {
    "ternary_matmul": ("split", "tile"),
    "qlinear": ("split", "tile"),
    "ffn": ("split_gu", "split_down", "tile"),
    "prefill": (),
    "decode": ("stages",),
}

# the ternary tile core (csrc/ternary_tile.cuh): k a stage, the largest
# cluster, the two row tiles (rows → dynamic shared-memory bytes), the
# threads a CTA and the output columns a tile (a gate‖up tile: 64 of h)
K_STAGE = 128
MAX_SPLIT = 8
TILE_SMEM = {16: 29696, 128: 94208}
TILE_THREADS = 128
TILE_COLS = 128
# registers a thread of each GEMM kernel by row tile, as ptxas reports
# them for sm_90a (``nvcc -Xptxas -v``, the build's log): the residency
# model's third limit, which binds the 16-row tiles
TILE_REGS = {"ternary_matmul": {16: 96, 128: 228},
             "qlinear": {16: 94, 128: 230},
             "gate_up": {16: 128, 128: 222}}
# the split-lane decode core (csrc/int8_decode.cuh); registers of the
# larger of the LOP and dense kernels, one-row instance and the other
DECODE_STAGES = (2, 3, 4)
DEFAULT_DECODE_STAGES = 2
DECODE_THREADS = 128
DECODE_WARPS = 4
DECODE_REGS = {True: 64, False: 79}


# ---------------------------------------------------------------------------
# Table I/O and dispatch lookup
# ---------------------------------------------------------------------------

_OVERRIDES: dict[str, dict] = {}
_CACHE: dict[str, tuple[float, dict]] = {}


def table_path() -> Path:
    return Path(os.environ.get(TABLE_ENV, DEFAULT_TABLE))


@functools.lru_cache(maxsize=None)
def _device_key(index: int) -> str:
    import torch
    major, minor = torch.cuda.get_device_capability(index)
    return f"cuda:{torch.cuda.get_device_name(index)}:sm_{major}{minor}"


def config_key() -> str:
    """The card the timings belong to: ``cuda:<name>:sm_<major><minor>``
    of the current CUDA device. Raises without a card: no tile runs on
    the CPU, so nothing there has a key."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("autotune: no CUDA card — the tiles are timed and "
                           "looked up on a card only")
    return _device_key(torch.cuda.current_device())


def shape_key(kernel: str, dims: dict) -> str:
    names = KERNEL_DIMS[kernel]
    assert set(dims) == set(names), (kernel, dims)
    return ",".join(f"{k}={int(dims[k])}" for k in names)


def parse_shape_key(skey: str) -> dict:
    """``"m=4,k=3200"`` → ``{"m": 4, "k": 3200}`` (ValueError if malformed)."""
    return {k: int(v) for k, v in (kv.split("=") for kv in skey.split(","))}


def load_table(path: str | Path | None = None) -> dict:
    """Parse the table (``{}`` when absent or unreadable), mtime-cached.
    Dispatch calls it on every launch it tunes, so an absent table costs
    one ``stat``."""
    key = str(path) if path is not None else os.environ.get(
        TABLE_ENV, _DEFAULT_TABLE)
    try:
        mtime = os.stat(key).st_mtime
    except OSError:
        return {}
    cached = _CACHE.get(key)
    if cached and cached[0] == mtime:
        return cached[1]
    try:
        table = json.loads(Path(key).read_text())
    except (OSError, ValueError):
        return {}
    if not isinstance(table, dict):
        table = {}
    _CACHE[key] = (mtime, table)
    return table


def save_table(table: dict, path: str | Path | None = None) -> Path:
    p = Path(path) if path is not None else table_path()
    p.write_text(json.dumps(table, indent=2, sort_keys=True) + "\n")
    _CACHE.pop(str(p), None)
    return p


@contextlib.contextmanager
def override(kernel: str, **params):
    """Force ``params`` for every ``lookup(kernel, ...)`` in the block —
    the first leg of the precedence chain (beats the table)."""
    assert kernel in KERNELS, kernel
    prev = _OVERRIDES.get(kernel)
    _OVERRIDES[kernel] = dict(params)
    try:
        yield
    finally:
        if prev is None:
            _OVERRIDES.pop(kernel, None)
        else:
            _OVERRIDES[kernel] = prev


def k_steps(k: int) -> int:
    """k-stages of the ternary tile core over a reduction of k."""
    return -(-k // K_STAGE)


def _split_ok(split: int, k: int) -> bool:
    return 0 <= split <= min(MAX_SPLIT, k_steps(k))


def _up16(x: int) -> int:
    return (x + 15) & ~15


def decode_smem(dims: dict, stages: int, lop: bool = True) -> int:
    """Dynamic shared-memory bytes of one decode CTA at ring depth
    ``stages`` — ``layout()`` of ``csrc/int8_decode.cuh``, restated."""
    g, d, block, k_keep = dims["g"], dims["d"], dims["block"], dims["k_keep"]
    nb = dims["m"] // block
    stage = max(_up16(block * d) + _up16(4 * block),
                _up16(block * d // 2) if lop else 0)
    parts = [4 * g, 4 * g, 4 * g * d]                  # the CTA's partial
    one_row = g == 1 and block <= DECODE_THREADS
    warps = [4 * DECODE_WARPS * g, 4 * DECODE_WARPS * g,
             4 * DECODE_WARPS * g * d]
    if one_row:
        parts += warps
    o = max(sum(_up16(b) for b in parts), stages * stage)
    rest = [g * d]
    if not one_row:
        rest += [4 * g * block] + warps
    if lop:
        share = -(-nb // MAX_SPLIT)
        rest += [g * d, 4 * g * nb, 4 * g * nb, 4 * g * k_keep,
                 4 * (g * k_keep + 1), 4 * share * DECODE_WARPS * g]
    return o + sum(_up16(b) for b in rest)


def valid_params(kernel: str, dims: dict, params: dict) -> bool:
    """Legality screen for a (possibly stale) table entry or override."""
    if not isinstance(params, dict):
        return False
    if not set(params) <= set(KERNEL_PARAMS[kernel]):
        return False
    try:
        p = {k: int(v) for k, v in params.items()}
    except (TypeError, ValueError):
        return False
    if p.get("tile", 0) not in (0, *TILE_SMEM):
        return False
    if kernel in ("ternary_matmul", "qlinear"):
        return _split_ok(p.get("split", 0), dims["k"])
    if kernel == "ffn":
        return (_split_ok(p.get("split_gu", 0), dims["k"])
                and _split_ok(p.get("split_down", 0), dims["f"]))
    if kernel == "prefill":
        return not p
    if kernel == "decode":
        stages = p.get("stages", 0)
        return ((stages == 0 or stages in DECODE_STAGES)
                and decode_smem(dims, stages or DEFAULT_DECODE_STAGES)
                <= smem_budget())
    return False


def lookup(kernel: str, dims: dict) -> dict:
    """Tuned params for this kernel and shape, or ``{}`` (the planner's).

    In precedence order: override context → table entry under the card's
    key (``REPRO_TORCH_TUNE=0`` turns this leg off) → ``{}``. An illegal
    or stale entry falls through to ``{}`` rather than fail dispatch.
    """
    ov = _OVERRIDES.get(kernel)
    if ov is not None:
        return dict(ov) if valid_params(kernel, dims, ov) else {}
    if os.environ.get(TUNE_ENV, "1") == "0":
        return {}
    table = load_table()
    if not table:
        return {}
    entry = (table.get("configs", {}).get(config_key(), {})
             .get(kernel, {}).get(shape_key(kernel, dims)))
    if not isinstance(entry, dict):
        return {}
    params = entry.get("params", {})
    return dict(params) if valid_params(kernel, dims, params) else {}


# ---------------------------------------------------------------------------
# Shape log: every distinct dispatch shape into a JSON sidecar, which a
# later sweep on the card reads back (``--from-log``), so the swept set
# grows from the shapes served traffic dispatches.
# ---------------------------------------------------------------------------

_SHAPE_LOG: dict = {"path": None, "seen": set()}


def shape_log_path() -> Path | None:
    """The active sidecar: ``start_shape_log`` first, then the
    ``REPRO_TORCH_SHAPE_LOG`` environment (a path, or ``1`` for the
    repository's default). ``None``: logging off, the default."""
    if _SHAPE_LOG["path"] is not None:
        return _SHAPE_LOG["path"]
    env = os.environ.get(SHAPE_LOG_ENV)
    if not env or env == "0":
        return None
    return DEFAULT_SHAPE_LOG if env == "1" else Path(env)


def start_shape_log(path: str | Path | None = None) -> Path:
    """Turn shape logging on (``PooledEngine(shape_log=...)``)."""
    p = Path(path) if path is not None else DEFAULT_SHAPE_LOG
    _SHAPE_LOG["path"] = p
    _SHAPE_LOG["seen"] = set()
    return p


def stop_shape_log() -> None:
    _SHAPE_LOG["path"] = None
    _SHAPE_LOG["seen"] = set()


def observe(kernel: str, dims: dict) -> None:
    """Record one dispatch shape in the sidecar (deduplicated, written
    through). ``ops.py``'s entries call it on every dispatch; with no log
    armed it returns at once, and a shape already seen costs a set lookup.
    The read-modify-write keeps the file a union across processes."""
    p = shape_log_path()
    if p is None or kernel not in KERNEL_DIMS:
        return
    skey = shape_key(kernel, dims)
    key = (str(p), kernel, skey)
    if key in _SHAPE_LOG["seen"]:
        return
    _SHAPE_LOG["seen"].add(key)
    try:
        log = json.loads(p.read_text())
    except (OSError, ValueError):
        log = {}
    if not isinstance(log, dict):
        log = {}
    log.setdefault("version", SHAPE_LOG_VERSION)
    shapes = log.setdefault("shapes", {}).setdefault(kernel, [])
    if skey not in shapes:
        shapes.append(skey)
        shapes.sort()
    p.write_text(json.dumps(log, indent=2, sort_keys=True) + "\n")


def load_shape_log(path: str | Path | None = None) -> dict:
    """Sidecar → ``{kernel: [dims, ...]}`` (malformed entries dropped)."""
    p = Path(path) if path is not None else (shape_log_path()
                                             or DEFAULT_SHAPE_LOG)
    try:
        log = json.loads(p.read_text())
    except (OSError, ValueError):
        return {}
    out: dict[str, list[dict]] = {}
    for kernel, skeys in (log.get("shapes") or {}).items():
        if kernel not in KERNELS or not isinstance(skeys, list):
            continue
        for skey in skeys:
            try:
                dims = parse_shape_key(skey)
            except (ValueError, AttributeError):
                continue
            if set(dims) != set(KERNEL_DIMS[kernel]):
                continue
            out.setdefault(kernel, []).append(dims)
    return out


def merged_shapes(path: str | Path | None = None) -> dict:
    """DEFAULT_SHAPES grown by the sidecar's logged shapes (deduplicated)
    — the sweep set of ``--from-log``."""
    out = {k: [dict(d) for d in v] for k, v in DEFAULT_SHAPES.items()}
    for kernel, shapes in load_shape_log(path).items():
        for dims in shapes:
            if dims not in out.setdefault(kernel, []):
                out[kernel].append(dims)
    return out


def validate_table(path: str | Path | None = None) -> list[str]:
    """The static gate: every entry parses, names a known kernel, carries
    a well-formed shape key and passes the legality screen against its own
    dims. → problems (empty = OK; a missing table is OK — the planner's
    choices are the contract)."""
    p = Path(path) if path is not None else table_path()
    if not p.exists():
        return []
    try:
        table = json.loads(p.read_text())
    except (OSError, ValueError) as e:
        return [f"{p}: unparseable ({e})"]
    problems = []
    if table.get("version") != TABLE_VERSION:
        problems.append(f"{p}: version {table.get('version')!r} "
                        f"!= {TABLE_VERSION}")
    for cfg, kernels in table.get("configs", {}).items():
        for kernel, entries in kernels.items():
            if kernel not in KERNELS:
                problems.append(f"{cfg}: unknown kernel {kernel!r}")
                continue
            for skey, entry in entries.items():
                try:
                    dims = parse_shape_key(skey)
                except ValueError:
                    problems.append(f"{cfg}/{kernel}: bad shape key {skey!r}")
                    continue
                if set(dims) != set(KERNEL_DIMS[kernel]):
                    problems.append(f"{cfg}/{kernel}: {skey!r} dims != "
                                    f"{KERNEL_DIMS[kernel]}")
                    continue
                params = entry.get("params") if isinstance(entry, dict) \
                    else None
                if not valid_params(kernel, dims, params):
                    problems.append(f"{cfg}/{kernel}/{skey}: illegal params "
                                    f"{params!r}")
    return problems


# ---------------------------------------------------------------------------
# Candidates: the knob space, pruned by shared memory and a static
# residency model of the card, ranked by the k-stages the slowest SM walks
# ---------------------------------------------------------------------------

def _gemm_plan(m: int, k: int, n_out: int, split: int, tile: int, *,
               experts: int = 1, paired: bool = False,
               kernel: str = "qlinear") -> dict:
    """One GEMM launch of the ternary tile core as the static model sees
    it: the tile, CTAs, the CTAs resident at once (0: the CTA cannot run),
    the waves, the k-stages of the slowest SM, and the bytes moved (the
    packed weights once a row tile, the int8 rows once a column tile)."""
    bm = tile or (16 if m <= 16 else 128)
    cols = TILE_COLS // 2 if paired else TILE_COLS
    row_tiles, col_tiles = -(-m // bm), -(-n_out // cols)
    tiles = experts * row_tiles * col_tiles
    regs = TILE_REGS["gate_up" if paired else kernel][bm]
    per_sm = resident_ctas_per_sm(TILE_THREADS, TILE_SMEM[bm], regs)
    resident = per_sm * SMS
    steps = k_steps(k)
    if split == 0:                  # the planner: one wave, largest cluster
        split = 1
        for s in range(min(MAX_SPLIT, steps), 1, -1):
            if tiles <= resident // s:
                split = s
                break
    ctas = tiles * split
    waves = -(-ctas // resident) if resident else math.inf
    packed_cols = n_out * (2 if paired else 1)
    nbytes = experts * (row_tiles * (k // 4) * packed_cols
                        + col_tiles * m * k)
    return {"tile": bm, "split": split, "ctas": ctas, "resident": resident,
            "waves": waves, "serial": waves * -(-steps // split),
            "bytes": nbytes}


def modeled_cost(kernel: str, dims: dict, p: dict) -> tuple:
    """Static rank of a candidate (lower first): k-stages (or, for the
    decode kernel, waves) on the slowest SM, then bytes moved, then CTAs.
    A model for ordering the sweep, not a time."""
    d = dims
    if kernel in ("ternary_matmul", "qlinear"):
        g = _gemm_plan(d["m"], d["k"], d["n"], p["split"], p["tile"],
                       experts=d.get("e", 1), kernel=kernel)
        return (g["serial"], g["bytes"], g["ctas"])
    if kernel == "ffn":
        gu = _gemm_plan(d["m"], d["k"], d["f"], p["split_gu"], p["tile"],
                        experts=d["e"], paired=True)
        dn = _gemm_plan(d["m"], d["f"], d["n"], p["split_down"], p["tile"],
                        experts=d["e"])
        return (gu["serial"] + dn["serial"], gu["bytes"] + dn["bytes"],
                gu["ctas"] + dn["ctas"])
    if kernel == "decode":
        stages = p["stages"] or DEFAULT_DECODE_STAGES
        nb = d["m"] // d["block"]
        share = -(-nb // MAX_SPLIT)
        ctas = d["bhg"] * -(-nb // share)
        one_row = d["g"] == 1 and d["block"] <= DECODE_THREADS
        per_sm = resident_ctas_per_sm(DECODE_THREADS, decode_smem(d, stages),
                                      DECODE_REGS[one_row])
        waves = -(-ctas // (per_sm * SMS)) if per_sm else math.inf
        # deeper rings hide more copy latency: among equal waves, deeper
        return (waves, -stages, 0)
    return (0, 0, 0)


def _fits(kernel: str, dims: dict, p: dict) -> bool:
    """Within the card's shared memory and resident (the static model)."""
    if kernel in ("ternary_matmul", "qlinear", "ffn"):
        bm = p["tile"] or (16 if dims["m"] <= 16 else 128)
        return (TILE_SMEM[bm] <= smem_budget()
                and resident_ctas_per_sm(TILE_THREADS, TILE_SMEM[bm]) > 0)
    if kernel == "decode":
        smem = decode_smem(dims, p["stages"] or DEFAULT_DECODE_STAGES)
        return (smem <= smem_budget()
                and resident_ctas_per_sm(DECODE_THREADS, smem) > 0)
    return True


def candidates(kernel: str, dims: dict, *,
               max_candidates: int = 12) -> list[dict]:
    """Legal candidates, pruned and ranked (best first). Candidate 0 is
    the default — every knob 0, the planner's own choice — so a sweep can
    never keep a tiling slower than the status quo."""
    d = dims
    raw: list[dict] = []
    if kernel in ("ternary_matmul", "qlinear"):
        raw = [{"split": s, "tile": t} for t in TILE_SMEM
               for s in range(1, min(MAX_SPLIT, k_steps(d["k"])) + 1)]
    elif kernel == "ffn":
        raw = [{"split_gu": a, "split_down": b, "tile": t} for t in TILE_SMEM
               for a in range(1, min(MAX_SPLIT, k_steps(d["k"])) + 1)
               for b in range(1, min(MAX_SPLIT, k_steps(d["f"])) + 1)]
    elif kernel == "decode":       # the default is the 2-stage ring
        raw = [{"stages": s} for s in DECODE_STAGES
               if s != DEFAULT_DECODE_STAGES]
    elif kernel != "prefill":
        raise ValueError(kernel)
    default = {name: 0 for name in KERNEL_PARAMS[kernel]}
    legal = [p for p in raw
             if valid_params(kernel, d, p) and _fits(kernel, d, p)]
    legal.sort(key=lambda p: modeled_cost(kernel, d, p))
    out = [default]
    for p in legal:
        if len(out) >= max_candidates:
            break
        if p not in out:
            out.append(p)
    return out


# ---------------------------------------------------------------------------
# The sweep: each candidate on synthetic operands at the shape, on the card
# ---------------------------------------------------------------------------

def _copies(torch, args, min_bytes: float = 100e6, cap: int = 16) -> list:
    """Enough copies of ``args`` that cycling through them exceeds L2."""
    nbytes = sum(a.numel() * a.element_size() for a in args)
    n = max(2, min(cap, math.ceil(min_bytes / max(nbytes, 1)) + 1))
    return [args] + [tuple(a.clone() for a in args) for _ in range(n - 1)]


def _bench_ms(torch, fn, arg_sets, repeats: int, per_graph: int = 20) -> float:
    """Median device ms a launch of ``fn(*args)``: ``per_graph`` launches
    cycling through ``arg_sets`` (so L2 starts cold) captured in one CUDA
    graph, each of ``repeats`` replays timed with CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*arg_sets[0])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(per_graph):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    samples = []
    for _ in range(max(1, repeats)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / per_graph)
    del graph
    samples.sort()
    return samples[len(samples) // 2]


def _make_runner(kernel: str, dims: dict):
    """Synthetic operands of one workload shape on the card → (the
    arguments, ``run(params) -> fn(*args)``: one call at the knobs — the
    decode kernel's LOP and dense modes, which share its key, both —
    returning the output tensor(s) the caller checks bitwise)."""
    import importlib

    import numpy as np
    import torch

    # the package re-exports ops' entries under the modules' names
    # (``decode_attention``, ``ternary_matmul``): bind the modules
    _dec = importlib.import_module("repro_torch.kernels.decode_attention")
    _ql = importlib.import_module("repro_torch.kernels.qlinear")
    _tmm = importlib.import_module("repro_torch.kernels.ternary_matmul")

    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(0)
    d = dims

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def i8(*shape):
        return t(rng.integers(-127, 128, size=shape).astype(np.int8))

    def u8(*shape):
        return t(rng.integers(0, 256, size=shape).astype(np.uint8))

    def f32(*shape, lo=0.01, hi=0.1):
        return t(rng.uniform(lo, hi, size=shape).astype(np.float32))

    if kernel == "ternary_matmul":
        args = (i8(d["m"], d["k"]), u8(d["k"] // 4, d["n"]))
        return args, lambda p: lambda x, w: _tmm.ternary_matmul(
            x, w, split=p["split"], tile=p["tile"])
    if kernel == "qlinear":
        e, m = d["e"], d["m"]
        args = (f32(e, m, d["k"], lo=-1.0, hi=1.0), u8(e, d["k"] // 4, d["n"]),
                f32(e, d["n"]))
        if e == 1:
            return args, lambda p: lambda x, w, g: _ql.fused_qlinear(
                x[0], w[0], g[0], split=p["split"], tile=p["tile"])
        return args, lambda p: lambda x, w, g: _ql.fused_qlinear_experts(
            x, w, g, split=p["split"], tile=p["tile"])
    if kernel == "ffn":
        e, m, k, f, n = d["e"], d["m"], d["k"], d["f"], d["n"]
        args = (f32(e, m, k, lo=-1.0, hi=1.0), u8(e, k // 4, 2 * f),
                f32(e, 2 * f), u8(e, f // 4, n), f32(e, n))
        fn = _ql.fused_ffn_experts if e > 1 else None

        def run(p):
            knobs = dict(split_gu=p["split_gu"], split_down=p["split_down"],
                         tile=p["tile"])
            if fn is not None:
                return lambda *a: fn(*a, gated=True, act="silu", **knobs)
            return lambda x, gu, gs, dn, ds: _ql.fused_ffn(
                x[0], gu[0], gs[0], dn[0], ds[0], gated=True, act="silu",
                **knobs)
        return args, run
    if kernel == "decode":
        bh, g, dh, m = d["bhg"], d["g"], d["d"], d["m"]
        new_len = rng.integers(m // 2, m + 1, size=bh).astype(np.int32)
        args = (i8(bh, g, dh), f32(bh, g), i8(bh, m, dh), i8(bh, m, dh),
                f32(bh, m), f32(bh, m), u8(bh, m, dh // 2), t(new_len))
        common = dict(hkv=1, block=d["block"], window=0,
                      softmax_scale=dh ** -0.5)

        def run(p):
            def both(qi, qsc, kc, vc, ks, vs, feat, nl):
                return (_dec.fused_decode_attention(
                    qi, qsc, kc, vc, ks, vs, feat, nl, k_keep=d["k_keep"],
                    stages=p["stages"], **common),
                    _dec.fused_dense_decode_attention(
                        qi, qsc, kc, vc, ks, vs, nl, stages=p["stages"],
                        **common))
            return both
        return args, run
    raise ValueError(f"{kernel}: nothing to sweep")


def sweep_kernel(kernel: str, dims: dict, *, repeats: int = 3,
                 max_candidates: int = 12, log=None) -> dict | None:
    """Time the candidate set of one shape on the card; → its table entry
    (``None`` for a kernel with no knob). Every candidate's output must be
    bitwise the default's on the same inputs: a difference raises."""
    import torch

    if not KERNEL_PARAMS[kernel]:
        return None
    args, runner = _make_runner(kernel, dims)
    arg_sets = _copies(torch, args)
    cands = candidates(kernel, dims, max_candidates=max_candidates)
    def outputs(fn):
        got = fn(*args)
        torch.cuda.synchronize()
        return got if isinstance(got, tuple) else (got,)

    want = outputs(runner(cands[0]))
    best = default_ms = None
    for p in cands:
        fn = runner(p)
        if not all(torch.equal(a, b) for a, b in zip(outputs(fn), want)):
            raise AssertionError(
                f"autotune: {kernel} {shape_key(kernel, dims)} {p} is not "
                f"bitwise the default launch — a knob changed the result")
        ms = _bench_ms(torch, fn, arg_sets, repeats)
        if default_ms is None:
            default_ms = ms
        if log:
            log(f"  {kernel} {shape_key(kernel, dims)} {p} -> {ms:.5f} ms")
        if best is None or ms < best["ms"]:
            best = {"params": p, "ms": ms}
    best["default_ms"] = default_ms
    best["candidates"] = len(cands)
    return best


# bitnet-3b's full-width shapes on its served path (d 3200, 32 heads of
# 100, ffn 8640, capacity 1664, 4 slots, 128-token chunks); a sweep adds
# the shapes a shape log holds
_BITNET_GEMMS = [(m, n) for m in (4, 128) for n in (9600, 3200)]
DEFAULT_SHAPES: dict[str, list[dict]] = {
    "ternary_matmul": [{"m": m, "k": 3200, "n": n} for m, n in _BITNET_GEMMS],
    "qlinear": [{"e": 1, "m": m, "k": 3200, "n": n}
                for m, n in _BITNET_GEMMS],
    "ffn": [{"e": 1, "m": m, "k": 3200, "f": 8640, "n": 3200}
            for m in (4, 128)],
    "decode": [{"bhg": 128, "g": 1, "d": 100, "m": 1664, "block": 128,
                "k_keep": 2}],
}


def run_sweep(kernels=None, shapes=None, *, out_path=None, repeats: int = 3,
              max_candidates: int = 12, log=print) -> dict:
    """Sweep on the current card and merge the winners into the table
    under its key (other cards' entries kept). Raises without a card."""
    key = config_key()
    kernels = list(kernels or KERNELS)
    shapes = shapes or DEFAULT_SHAPES
    path = Path(out_path) if out_path is not None else table_path()
    table = load_table(path) or {}
    table.setdefault("version", TABLE_VERSION)
    cfg = table.setdefault("configs", {}).setdefault(key, {})
    for kernel in kernels:
        if not KERNEL_PARAMS[kernel]:
            if shapes.get(kernel) and log:
                log(f"{kernel}: {len(shapes[kernel])} shape(s), no knob to "
                    f"sweep (its tiling is fixed by the fragment layout)")
            continue
        for dims in shapes.get(kernel, []):
            entry = sweep_kernel(kernel, dims, repeats=repeats,
                                 max_candidates=max_candidates, log=log)
            cfg.setdefault(kernel, {})[shape_key(kernel, dims)] = entry
            if log:
                log(f"{kernel} {shape_key(kernel, dims)}: default "
                    f"{entry['default_ms']:.5f} ms, best {entry['params']} "
                    f"{entry['ms']:.5f} ms of {entry['candidates']}")
    save_table(table, path)
    return table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", action="append", choices=KERNELS,
                    help="kernel(s) to sweep (default: all)")
    ap.add_argument("--out", default=None, help="table path (default: "
                    f"{TABLE_ENV} or {DEFAULT_TABLE.name})")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--max-candidates", type=int, default=12)
    ap.add_argument("--from-log", nargs="?", const=True, default=None,
                    metavar="PATH",
                    help="grow the swept-shape set from a serving shape log "
                         f"(PooledEngine shape_log= / {SHAPE_LOG_ENV}; "
                         f"default path {DEFAULT_SHAPE_LOG.name})")
    ap.add_argument("--check", action="store_true",
                    help="validate the table instead of sweeping")
    args = ap.parse_args(argv)
    if args.check:
        path = Path(args.out) if args.out else table_path()
        problems = validate_table(path)
        for p in problems:
            print(f"autotune: {p}", file=sys.stderr)
        print(f"autotune: table {'INVALID' if problems else 'OK'} ({path}"
              f"{'' if path.exists() else ', absent'})")
        return 1 if problems else 0
    shapes = None
    if args.from_log is not None:
        log_path = None if args.from_log is True else args.from_log
        shapes = merged_shapes(log_path)
        n_logged = sum(len(v) for v in load_shape_log(log_path).values())
        print(f"autotune: sweeping {n_logged} logged serving shape(s) on "
              f"top of the defaults")
    run_sweep(args.kernel, shapes, out_path=args.out, repeats=args.repeats,
              max_candidates=args.max_candidates)
    return 0


if __name__ == "__main__":
    sys.exit(main())
