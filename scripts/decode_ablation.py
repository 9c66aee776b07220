"""Where the decode kernels' time goes: variants of the two decode-attention
kernels (``csrc/decode_attention.cu`` on ``csrc/int8_decode.cuh``), each
with one phase taken out, timed at ``chip_smoke.py`` phase 3's shapes; and
variants of the two standalone kernels of the per-head LOP path, the LOP
screen (#6, ``csrc/lop_scores.cu``) and the block-sparse decode (#9,
``csrc/int8_attention.cu`` on the same core), at phase 5's shapes.

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
computes the wrong output; only its time means anything. The standalone
arms (names starting "#6" or "#9") time the screen over 128 (B, Hkv)
lanes of 1664 tokens at d 100 and the sparse decode over those lanes'
``select_blocks`` choices (K = 2 blocks of 128, new_len [1600, 1, 700,
1200]) the same way. Needs one CUDA card and ``nvcc``.
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
NO_PV = (CORE, "  else fold_values<kMasked>(ln, smem, L, stage, g0, g1, tstart, end, st);", "  else {}")
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
SCREEN, SPARSE = "lop_scores.cu", "int8_attention.cu"
S_LAUNCH_ONLY = (SCREEN, "  const int dw = d >> 2, rb = d >> 1;",
                 "  if (g > 0) return;\n  const int dw = d >> 2, rb = d >> 1;")
S_COPIES_ONLY = (SCREEN, "  if (tid >= n_tok) return;", "  if (tid >= n_tok || g > 0) return;")
S_NO_COPIES = (SCREEN, "    cp_async16(body_s + 16 * i, body + 16 * i, 16);",
               "    if (g < 0) cp_async16(body_s + 16 * i, body + 16 * i, 16);")
D_LAUNCH_ONLY = (SPARSE, "  const Layout L = layout(G, nb, d, block, 0, false);\n  const int lane",
                 "  if (G > 0) return;\n  const Layout L = layout(G, nb, d, block, 0, false);\n  const int lane")
D_NO_FOLDS = (SPARSE, "  ring(smem, L.stage, 2 * list[0],", "  ring(smem, L.stage, 0,")

# the standalone arms: name → (what it shows, source, substitutions)
STANDALONE = {
    "#6 as built": ("the committed LOP screen", SCREEN, []),
    "#6 launch only": ("every CTA returns at once", SCREEN, [S_LAUNCH_ONLY]),
    "#6 copies only": ("q and the tile copied, no decode, no scores", SCREEN,
                       [S_COPIES_ONLY]),
    "#6 no copies": ("decode + __dp4a on whatever the buffer holds", SCREEN,
                     [S_NO_COPIES]),
    "#9 as built": ("the committed block-sparse decode", SPARSE, []),
    "#9 launch only": ("every CTA returns at once", SPARSE, [D_LAUNCH_ONLY]),
    "#9 no folds": ("list, q, state, finish; no block folded", SPARSE,
                    [D_NO_FOLDS]),
    "#9 no cluster merge": ("rank 0 flushes its own partial", SPARSE,
                            [NO_MERGE]),
    "#9 no P·V": ("the value sum skipped", SPARSE, [NO_PV]),
}
LOP_ONLY = ("LOP: no exact", "LOP: no screen", "LOP: select only", "LOP: bare")
DENSE_ONLY = ("no cluster merge", "dense: launch only", "dense: no folds")


def build(names):
    """Build each variant (decode ones from ``VARIANTS``, standalone ones
    from ``STANDALONE``), one nvcc each, all at once. → {name: CDLL}."""
    from repro_torch.kernels import _build
    procs = {}
    for name in names:
        if name in STANDALONE:
            _, source, subs = STANDALONE[name]
        else:
            source, subs = KERN, VARIANTS[name][1]
        d = OUT / "".join(c if c.isalnum() else "_" for c in name)
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(CSRC, d)
        for fname, old, new in subs:
            f = d / fname
            text = f.read_text()
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer holds {old!r}")
            f.write_text(text.replace(old, new))
        lib = d / "lib.so"
        procs[name] = (subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(d / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib,
            source)
    libs = {}
    for name, (proc, lib, source) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        libs[name] = ctypes.CDLL(str(lib))
        for fn, (argtypes, restype) in _build.SIGNATURES[source[:-3]].items():
            f = getattr(libs[name], fn)
            f.argtypes, f.restype = argtypes, restype
    return libs


def standalone(torch, np, smoke, names, libs, card) -> None:
    """Time the #6 and #9 variants at phase 5's shapes (graph, L2 cold)."""
    from repro_torch.core.lop import lop_features, pack_features, pot
    from repro_torch.kernels import ref as plain
    from repro_torch.serving.lop_select import select_blocks

    dev = torch.device("cuda")
    rng = np.random.default_rng(smoke.SEED + 14)
    b, h, m, dh, blk = 4, 32, 1664, 100, 128
    n = b * h

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    qi = t(rng.integers(-127, 128, (n, 1, dh)).astype(np.int8))
    kd = t(rng.integers(-127, 128, (n, m, dh)).astype(np.int8))
    vd = t(rng.integers(-127, 128, (n, m, dh)).astype(np.int8))
    ks, vs, qs = (t((rng.random(shape) * 0.02 + 0.001).astype(np.float32))
                  for shape in ((n, m, 1), (n, m, 1), (n, 1, 1)))
    feat = pack_features(lop_features(kd))
    q_pot = pot(qi)
    scores = plain.lop_scores_ref(q_pot, feat)
    idx, gt = select_blocks(scores.reshape(b, h, 1, m), torch.tensor(
        smoke.PER_HEAD_LEN, dtype=torch.int32, device=dev), block=blk,
        k_keep=2)
    nb = idx.shape[-1]
    idx, gt = idx.reshape(n, nb).contiguous(), gt.reshape(n, 3 * nb).contiguous()
    sargs = (qi, kd, vd, qs, ks, vs, idx, gt)
    sm = dh ** -0.5
    want9 = plain.sparse_decode_attention_ref(*sargs, block=blk,
                                              softmax_scale=sm)

    def screen(lib, q_, f_):
        out = torch.empty((n, 1, m), dtype=torch.int32, device=dev)
        rc = lib.repro_lop_scores(q_.data_ptr(), f_.data_ptr(),
                                  out.data_ptr(), n, 1, m, dh,
                                  torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed with CUDA error {rc}")
        return out

    def sparse(lib, q_, k_, v_, qs_, ks_, vs_, i_, g_):
        out = torch.empty((n, 1, dh), dtype=torch.float32, device=dev)
        rc = lib.repro_sparse_decode(
            q_.data_ptr(), qs_.data_ptr(), k_.data_ptr(), v_.data_ptr(),
            ks_.data_ptr(), vs_.data_ptr(), i_.data_ptr(), g_.data_ptr(),
            out.data_ptr(), n, 1, m, dh, nb, 1, blk, sm,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed with CUDA error {rc}")
        return out

    sets6 = smoke.copies(torch, (q_pot, feat))
    sets9 = smoke.copies(torch, sargs)
    print(f"standalone kernels at phase 5's shapes: #6 {n} lanes, g=1, M={m},"
          f" d={dh}; #9 {n} lanes, g=1, K={nb} blocks of {blk}, new_len "
          f"{list(smoke.PER_HEAD_LEN)} [{card}]", flush=True)
    for name in names:
        lib = libs[name]
        if name.startswith("#6"):
            fn, sets = (lambda *a: screen(lib, *a)), sets6
            err = float((screen(lib, q_pot, feat) - scores).abs().max())
            plan = (ctypes.c_int * 3)()
            lib.repro_lop_scores_plan(1, dh, ctypes.addressof(plan))
            shape = f"{n * -(-m // plan[0])} CTAs, {plan[2]} B smem"
        else:
            fn, sets = (lambda *a: sparse(lib, *a)), sets9
            err = float((sparse(lib, *sargs) - want9).abs().max())
            plan = (ctypes.c_int * 4)()
            lib.repro_sparse_decode_plan(1, nb, dh, blk, ctypes.addressof(plan))
            shape = f"{n * plan[0]} CTAs ({plan[0]} a lane), {plan[3]} B smem"
        ms = smoke.graph_ms(torch, fn, sets)
        print(f"  {name:<22} {shape}; {ms:.4f} ms (max |err| {err:.2g}) — "
              f"{STANDALONE[name][0]}", flush=True)


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
    alone = [n for n in STANDALONE if not sys.argv[1:] or n in sys.argv[1:]]
    libs = build(names + alone)
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
    data = {k: inputs(*v) for k, v in cases.items()} if names else {}
    sets = {k: smoke.copies(torch, v) for k, v in data.items()}
    if names:
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
    if alone:
        standalone(torch, np, smoke, alone, libs, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
