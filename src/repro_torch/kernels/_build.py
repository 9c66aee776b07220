"""Build the CUDA sources under ``csrc/`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into
``build/repro_torch/<name>-<hash>.so`` at the repository root:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o <lib> csrc/<name>.cu

(never ``--use_fast_math``). ``<hash>`` covers the source and every
``csrc/*.cuh`` header, so an edit to either rebuilds and a stale library
is never loaded; the ptxas report (registers, shared memory, spills)
lands beside it as ``<name>-<hash>.log``. :func:`build_all` starts one ``nvcc`` per source at
once. Nothing is built at import: the first launch builds what it needs.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("qlinear", "prefill_attention", "decode_attention",
           "ternary_matmul", "lop_scores", "int8_attention")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of every entry point: name → (argtypes, restype)
SIGNATURES = {
    "qlinear": {
        "repro_qlinear": ([_P] * 7 + [_I] * 7 + [_P], _I),
        "repro_ffn": ([_P] * 11 + [_I] * 10 + [_P], _I),
        "repro_qlinear_shape": ([_I] * 7 + [_P], _I),
    },
    "prefill_attention": {
        "repro_prefill_attention": ([_P] * 8 + [_I] * 9 + [_F, _P], _I),
        "repro_prefill_max_d": ([], _I),
        "repro_prefill_warps": ([], _I),
        "repro_prefill_rows": ([], _I),
        "repro_prefill_smem_bytes": ([_I], ctypes.c_size_t),
    },
    "decode_attention": {
        "repro_decode_plan": ([_I] * 7 + [_P], _I),
        "repro_decode_occupancy": ([_I] * 7 + [_P], _I),
        "repro_lop_decode_attention": ([_P] * 11 + [_I] * 11 + [_F, _P],
                                       _I),
        "repro_dense_decode_attention": ([_P] * 10 + [_I] * 9 + [_F, _P],
                                         _I),
    },
    "ternary_matmul": {
        "repro_ternary_matmul": ([_P] * 3 + [_I] * 5 + [_P], _I),
        "repro_ternary_matmul_shape": ([_I] * 5 + [_P], _I),
    },
    "lop_scores": {
        "repro_lop_scores": ([_P] * 3 + [_I] * 4 + [_P], _I),
        "repro_lop_scores_plan": ([_I] * 2 + [_P], _I),
    },
    "int8_attention": {
        "repro_flash_prefill": ([_P] * 7 + [_I] * 4 + [_F, _P], _I),
        "repro_flash_prefill_max_d": ([], _I),
        "repro_flash_prefill_warps": ([], _I),
        "repro_flash_prefill_rows": ([], _I),
        "repro_flash_prefill_smem_bytes": ([_I], ctypes.c_size_t),
        "repro_sparse_decode": ([_P] * 9 + [_I] * 7 + [_F, _P], _I),
        "repro_sparse_decode_plan": ([_I] * 4 + [_P], _I),
        "repro_sparse_decode_occupancy": ([_I] * 4 + [_P], _I),
    },
}


def nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for one source; → (Popen | None, lib path)."""
    lib = _lib_path(name)
    if lib.exists():
        return None, lib
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = lib.parent / f"{lib.name}.{os.getpid()}.tmp"
    log = open(lib.with_suffix(".log"), "w")
    proc = subprocess.Popen(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=log, stderr=subprocess.STDOUT)
    proc._repro = (tmp, lib, log)  # type: ignore[attr-defined]
    return proc, lib


def _finish(proc) -> None:
    tmp, lib, log = proc._repro
    try:
        rc = proc.wait()
    finally:
        log.close()
    if rc != 0:
        raise RuntimeError(f"nvcc failed for {lib.name}:\n"
                           + lib.with_suffix(".log").read_text())
    os.replace(tmp, lib)


def build_all(names=SOURCES) -> dict[str, Path]:
    """Compile every source not yet built, all nvcc processes at once."""
    started = [_start(n) for n in names]
    try:
        for proc, _ in started:
            if proc is not None:
                _finish(proc)
    finally:
        for proc, _ in started:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
    return {n: lib for n, (_, lib) in zip(names, started)}


def ptxas_report(name: str) -> str:
    """Register / shared-memory / spill lines nvcc printed for ``name``."""
    log = _lib_path(name).with_suffix(".log")
    if not log.exists():
        return ""
    keep = ("registers", "spill", "smem", "Compiling entry")
    return "\n".join(line for line in log.read_text().splitlines()
                     if any(k in line for k in keep))


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build ``name`` if needed and load it with its C signatures set."""
    lib = ctypes.CDLL(str(build_all((name,))[name]))
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    return lib


def count_mode(fn, mode: str) -> None:
    """Count one launch of ``fn`` also under ``mode`` (a kernel mode, such
    as a projection's bias or a non-causal prefill), beside the launch
    count the wrapper keeps in ``fn.launches``."""
    fn.modes[mode] = fn.modes.get(mode, 0) + 1


def check(rc: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error "
                           f"{rc} (cudaError_t)")
