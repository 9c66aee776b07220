"""Where the decode kernels' time goes: variants of the two decode-attention
kernels (``csrc/decode_attention.cu`` on ``csrc/int8_decode.cuh``), each
with one phase taken out, timed at ``chip_smoke.py`` phase 3's shapes.

    python3 scripts/decode_ablation.py [VARIANT ...]

Each variant is the committed source with one text substitution (a phase
skipped, a constant changed), built with the same ``nvcc`` flags into
``build/decode_ablation/<variant>/`` (one ``nvcc`` per variant, all at
once); a substitution whose text the source no longer holds stops the
script, so an edit to the kernels asks for its variants to be brought up
to date. Each build is loaded with the C signatures of
``kernels/_build.py``. For each it prints the resident clusters the card
holds and CTAs per SM (``repro_decode_occupancy``), dynamic shared memory,
and the device time per call (calls captured in one CUDA graph, inputs
rotated so L2 starts cold) of the LOP (#4) and dense (#5) kernel at B = 4
(new_len [1600, 0, 700, 1200]) and B = 1 (new_len [1600]), beside the
largest |error| against the plain version. A variant that skips a phase
computes the wrong output; only its time means anything. Needs one CUDA
card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "decode_ablation"
CORE, KERN = "int8_decode.cuh", "decode_attention.cu"

NO_MERGE = (CORE, "  const int split = gridDim.x, rank = blockIdx.x;\n  cg::cluster_group",
            "  if (blockIdx.x) return;\n  const int split = 1, rank = 0;\n  cg::cluster_group")
NO_PV = (CORE, "  else fold_values(ln, smem, L, stage, g0, g1, tstart, end, st);", "  else {}")
NO_SCREEN = (KERN, "  ring(smem, L.stage, max(a1 - a0, 0),", "  ring(smem, L.stage, 0,")
NO_EXACT = (KERN, "  ring(smem, L.stage, 2 * mine[G * k_keep],", "  ring(smem, L.stage, 0,")
NO_GATHER = (KERN, "  if (split > 1) {\n    cluster.sync();\n    for (int i = threadIdx.x; i < G * nb;",
             "  if (split > 1 && G < 0) {\n    cluster.sync();\n    for (int i = threadIdx.x; i < G * nb;")
FIRST_K = (KERN, "    rank_row(blk + g * nb, rnk + g * nb, nb, k_keep);",
           "    for (int j = 0; j < nb; ++j) rnk[g * nb + j] = j < k_keep ? j : nb + k_keep + 1;")
NO_FOLD = (KERN, "  ring(smem, L.stage, 2 * max(a1 - a0, 0),", "  ring(smem, L.stage, 0,")
LAUNCH_ONLY = (KERN, "  const Layout L = layout(G, nb, d, block, 0, false);",
               "  if (G > 0) return;\n  const Layout L = layout(G, nb, d, block, 0, false);")
SMEM_STATE = (CORE, "  return G == 1 && block <= kThreads;", "  return false;")
SPLIT5 = (CORE, "constexpr int kMaxSplit = 8;", "constexpr int kMaxSplit = 5;")

# name → (what it shows, substitutions); the LOP-only variants change only
# the LOP kernel, the dense-only ones only the dense kernel
VARIANTS = {
    "as built": ("the committed kernels", []),
    "state in smem": ("one_row off: warp state in shared memory, 7 CTAs an SM",
                      [SMEM_STATE]),
    "split 5": ("shares of 3 blocks, 5 CTAs a lane", [SPLIT5]),
    "no cluster merge": ("rank 0 flushes its own partial (dense)", [NO_MERGE]),
    "no P·V": ("the value sum skipped", [NO_PV]),
    "dense: launch only": ("every CTA returns at once", [LAUNCH_ONLY]),
    "dense: no folds": ("q, state, finish; no block folded", [NO_FOLD]),
    "LOP: no exact": ("screen + select + finish", [NO_EXACT]),
    "LOP: no screen": ("first K blocks, exact + finish", [NO_SCREEN, FIRST_K]),
    "LOP: select only": ("gather + select + finish", [NO_SCREEN, NO_EXACT]),
    "LOP: bare": ("q, state, finish", [NO_SCREEN, NO_EXACT, NO_GATHER, FIRST_K]),
}
LOP_ONLY = ("LOP: no exact", "LOP: no screen", "LOP: select only", "LOP: bare")
DENSE_ONLY = ("no cluster merge", "dense: launch only", "dense: no folds")


def build(names):
    from repro_torch.kernels import _build
    procs = {}
    for name in names:
        d = OUT / name.replace(" ", "_").replace(":", "").replace("·", "")
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(CSRC, d)
        for fname, old, new in VARIANTS[name][1]:
            f = d / fname
            text = f.read_text()
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer holds {old!r}")
            f.write_text(text.replace(old, new))
        lib = d / "lib.so"
        procs[name] = (subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(d / KERN)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        libs[name] = ctypes.CDLL(str(lib))
        for fn, (argtypes, restype) in _build.SIGNATURES["decode_attention"].items():
            f = getattr(libs[name], fn)
            f.argtypes, f.restype = argtypes, restype
    return libs


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("decode_ablation: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from repro_torch.core.lop import lop_features, pack_features
    from repro_torch.kernels import ref as plain

    names = [n for n in VARIANTS if not sys.argv[1:] or n in sys.argv[1:]]
    libs = build(names)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    h, m, dh, blk, k_keep = 32, 1664, 100, 128, 2

    def inputs(b, lens):
        rng = np.random.default_rng(smoke.SEED)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        bh = b * h
        kd = t(rng.integers(-127, 128, (bh, m, dh)).astype(np.int8))
        return (t(rng.integers(-127, 128, (bh, 1, dh)).astype(np.int8)),
                t((rng.random((bh, 1)) * 0.02 + 0.001).astype(np.float32)),
                kd, t(rng.integers(-127, 128, (bh, m, dh)).astype(np.int8)),
                t((rng.random((bh, m)) * 0.02 + 0.001).astype(np.float32)),
                t((rng.random((bh, m)) * 0.02 + 0.001).astype(np.float32)),
                pack_features(lop_features(kd)),
                torch.tensor(lens, dtype=torch.int32, device=dev))

    def call(lib, lop, a):
        qi, qsc, kd, vd, ksd, vsd, feat, nl = a
        bh = qi.shape[0]
        out = torch.empty((bh, 1, dh), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [x.data_ptr() for x in (qi, qsc, kd, vd, ksd, vsd)]
        if lop:
            rc = lib.repro_lop_decode_attention(
                *ptrs, feat.data_ptr(), nl.data_ptr(), out.data_ptr(), bh, 1,
                m, dh, h, blk, k_keep, 0, dh ** -0.5, stream)
        else:
            rc = lib.repro_dense_decode_attention(
                *ptrs, nl.data_ptr(), out.data_ptr(), bh, 1, m, dh, h, blk, 0,
                dh ** -0.5, stream)
        if rc:
            raise RuntimeError(f"launch failed with CUDA error {rc}")
        return out

    def want(lop, a, b):
        qi, qsc, kd, vd, ksd, vsd, feat, nl = a
        return plain.decode_attention_ref(
            qi.reshape(b, h, dh), qsc.reshape(b, h, 1),
            kd.reshape(b, h, m, dh), vd.reshape(b, h, m, dh),
            ksd.reshape(b, h, m), vsd.reshape(b, h, m),
            feat.reshape(b, h, m, dh // 2) if lop else None, nl, block=blk,
            k_keep=k_keep, window=0, softmax_scale=dh ** -0.5,
            use_lop=lop).reshape(b * h, 1, dh)

    cases = {"B=4": (4, [1600, 0, 700, 1200]), "B=1": (1, [1600])}
    data = {k: inputs(*v) for k, v in cases.items()}
    sets = {k: smoke.copies(torch, v) for k, v in data.items()}
    print(f"decode kernel ablation at M={m}, d={dh}, block={blk}, "
          f"k_keep={k_keep} [{card}]", flush=True)
    for name in names:
        lib = libs[name]
        for lop in (True, False):
            if (lop and name in DENSE_ONLY) or (not lop and name in LOP_ONLY):
                continue
            shape = (1, m // blk, dh, blk, k_keep if lop else 0, int(lop))
            plan, occ = (ctypes.c_int * 4)(), (ctypes.c_int * 2)()
            if (lib.repro_decode_plan(*shape, ctypes.addressof(plan))
                    or lib.repro_decode_occupancy(*shape, ctypes.addressof(occ))):
                raise RuntimeError(f"{name}: plan or occupancy query failed")
            parts = []
            for k, (b, _) in cases.items():
                got = call(lib, lop, data[k])
                torch.cuda.synchronize()
                err = float((got - want(lop, data[k], b)).abs().max())
                ms = smoke.graph_ms(torch, lambda *a: call(lib, lop, a), sets[k])
                parts.append(f"{k} {ms:.4f} ms (max |err| {err:.2g})")
            print(f"  {'#4 LOP  ' if lop else '#5 dense'} {name:<20} "
                  f"{occ[0]} clusters of {plan[0]}, {occ[1]} CTAs/SM, "
                  f"{plan[3]} B smem; " + "; ".join(parts) + f" — "
                  f"{VARIANTS[name][0]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
