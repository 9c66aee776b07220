#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no result line is
printed:

  1. device   the card's name, count, and ``nvidia-smi`` name/power limit;
  2. build    every CUDA source under ``src/repro_torch/csrc`` (one nvcc per
              source, all at once), with ptxas' register/smem/spill lines;
  3. kernels  each kernel at the main path's full-width shapes
              (bitnet-3b: d 3200, 32 heads of 100, ffn 8640, capacity
              1664), held against its plain PyTorch version on the same
              inputs, then timed with CUDA events (inputs rotated over
              >100 MB of copies so each launch finds L2 cold, as decode
              does), beside the plain version's time, the least time the
              card could take (bound) and, where one PyTorch call computes
              the same function, that call's time; #1 and #2 (on the
              ternary tile core) and #4 and #5 (on the split-lane decode
              core) also with their calls captured in one CUDA graph (the
              device's time without the host's), with their launch shapes
              and ptxas' registers / static smem / spills, and #2
              checked once more at f 14,336 on a narrow d (above the
              former k cap); for #3 also 12 chunks of 128 rows bitwise
              one whole 1536-row call, a sliding window of 512 against
              the plain version, and for #3
              and #8 (phase 5) the CTAs, warps per CTA, dynamic shared
              memory and ptxas' registers / static smem / spills;
  4. serve    full-width bitnet-3b with seeded random weights: 8 requests
              of 128–1536 prompt tokens (numpy default_rng(0)), 32 new
              tokens each, through the continuous-batching Scheduler on 4
              slots, greedy, LOP decode; launch counts are zeroed just
              before and read just after each path, and every kernel of
              the path must show launches; the Scheduler's tokens must
              equal lockstep_generate's for 2 requests, and chunked prefill
              must equal whole-prompt prefill bitwise for one prompt; then
              clean timings: a decode step over 4 active lanes with no
              prefill in flight, one prefill chunk, a whole-prompt prefill,
              and a torch.profiler breakdown of decode steps and of one
              chunk; every serve run prints a sha256 of its tokens. Every
              serve run decodes through the engine's CUDA graphs (one
              replay a step, launch counts counted per replay); the clean
              decode step is timed and profiled on the graphs and on an
              eager twin engine sharing the weights, whose tokens must
              equal the graphs' and whose launch counts must equal 52 /
              26 / 26 of #1 / #2 / the decode kernel a step on both; the
              graphs held and the device memory they reserved are
              printed, and over the fresh caches of the lockstep checks
              the graphs' private memory pools must grow by exactly what
              the graphs held grew (an evicted graph gives its memory
              back) with at most GRAPH_BOUND keys left;
  4b. no-LOP  the same 8 requests on a use_lop=False engine sharing the
              weights: the dense decode kernel must launch and the LOP one
              must not; scheduler == lockstep for 2 requests; its steady
              decode step (graph and eager) beside the LOP engine's, and a
              torch.profiler breakdown of its decode steps;
  4c. sampled the 8 requests sampled (T 0.8, top-k 50, top-p 0.95, seed =
      + faults rid) on the LOP engine, scheduler == sampled lockstep for 2
              requests and the steady sampled decode step (graph and
              eager); then on the
              no-LOP engine 4 requests clean and under transient NaN
              logits (every fault recovered, every stream bitwise the
              clean one), a sticky NaN lane (reason "fault"), a 1 us
              deadline and a mid-decode cancellation; and the LOP engine
              under NaN logits, recovering through the dense retry (at
              least 3 retries on one pool, so the retry's graph is
              captured and replayed);
  5. standalone kernels and the per-head LOP decode, at full width:
              the TINT GEMM (ternary_matmul), the LOP screen
              (lop_scores_kernel), single-head flash prefill and block-sparse
              decode, each held against its plain version (integers
              bitwise, f32 at rtol = atol = 1e-4) and timed as in phase 3
              beside one PyTorch call for the same function; #7, #6 and
              #9 also with their calls captured in one CUDA graph (the
              device's time without the host's enqueue time), their launch
              shapes (CTAs, warps, dynamic smem; #7's k split, #9's
              cluster), ptxas' registers / static smem / spills and their
              shares of bound; #7 bitwise once more at k 27,392 x n 5,120
              (above the former k cap), #9 once more with the TPU kernel's
              masked cases (a gated empty interval, an all-masked lane, an
              ungated lane); then the paths
              a user of the kernel API runs, each with the launch counts
              zeroed before and read after: the TINT chain
              (ternary_matmul(quantize(x)) · x_scale · γ, bitwise
              qlinear_fused at the QKV and O shapes, m = 4 and 128), one
              1536-token flash prefill, and the paper's per-head
              predictive-sparse decode (lop_screen over every (batch,
              kv-head) lane → select_blocks → sparse_decode over every
              lane; 2 launches) against the fused LOP decode kernel (1
              launch) on the K/V of one layer of the serve engine's cache.

The line before the last two is the ``kernels`` JSON (nine entries); the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import hashlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12           # dense int8 tensor-core peak
F32_OPS_PER_S = 67e12              # f32 outside the tensor cores
TOL = dict(rtol=2e-5, atol=2e-5)
TOL_STANDALONE = dict(rtol=1e-4, atol=1e-4)   # the reference's kernel tests

SEED = 0
N_SLOTS, N_REQUESTS, GEN = 4, 8, 32
MIN_PROMPT, MAX_PROMPT = 128, 1536


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def cuda_ms(torch, fn, arg_sets, iters: int) -> float:
    """Mean ms per call of ``fn(*args)`` over ``iters`` calls, cycling
    through ``arg_sets`` (copies of the inputs) so L2 starts cold."""
    fn(*arg_sets[0])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, arg_sets, per_graph: int = 20, replays: int = 5) -> float:
    """Mean ms per call of ``fn(*args)`` with the calls captured in one CUDA
    graph (cycling through ``arg_sets``, L2 cold): the device's time for
    the launches, without the host's time to enqueue them."""
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
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * per_graph)


def copies(torch, args, min_bytes: float = 100e6, cap: int = 16) -> list:
    """Enough copies of ``args`` that cycling through them exceeds L2."""
    nbytes = sum(a.numel() * a.element_size() for a in args
                 if isinstance(a, torch.Tensor))
    n = max(2, min(cap, math.ceil(min_bytes / max(nbytes, 1)) + 1))
    return [args] + [tuple(a.clone() if isinstance(a, torch.Tensor) else a
                           for a in args) for _ in range(n - 1)]


def bound_ms(nbytes: float, int8_ops: float = 0.0,
             f32_ops: float = 0.0) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = int8_ops / INT8_OPS_PER_S + f32_ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def fmt_shape(shape: dict) -> str:
    """One launch of a kernel on the ternary tile core."""
    return (f"{shape['ctas']} CTAs x {shape['warps']} warps ({shape['tiles']} "
            f"tiles, k split {shape['split']}), {shape['smem']} B dynamic "
            f"smem")


def fmt_decode_shape(shape: dict) -> str:
    """One launch of a decode kernel on the split-lane core."""
    return (f"{shape['ctas']} CTAs x {shape['warps']} warps ({shape['split']}"
            f" a lane, one cluster; {shape['share']} blocks a CTA), "
            f"{shape['smem']} B dynamic smem; the card holds "
            f"{shape['resident_clusters']} such clusters at once, "
            f"{shape['ctas_per_sm']} CTAs an SM")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def ptxas_summary(build, source: str, kernel: str) -> str:
    """Registers, static shared memory and spills of one kernel, from the
    ptxas log nvcc wrote beside the library."""
    found, stats = False, {}
    for line in build.ptxas_report(source).splitlines():
        if "Compiling entry" in line:
            found = kernel in line
        elif found:
            for key, pat in (("registers", r"Used (\d+) registers"),
                             ("smem", r"(\d+) bytes smem"),
                             ("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads")):
                hit = re.search(pat, line)
                if hit:
                    stats[key] = int(hit.group(1))
    if "registers" not in stats:
        raise AssertionError(f"no ptxas report for {kernel} in {source}")
    return (f"ptxas: {stats['registers']} registers, {stats.get('smem', 0)} B "
            f"static smem, spills {stats.get('spill_stores', 0)} B stored / "
            f"{stats.get('spill_loads', 0)} B loaded")


# ---------------------------------------------------------------------------
# phase 3: kernels at the main path's shapes
# ---------------------------------------------------------------------------

def check_close(torch, name, got, want, bitwise=False, tol=TOL) -> float:
    torch.cuda.synchronize()
    if got.is_floating_point() and not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (float((got.double() - want.double()).abs().max())
           if got.numel() else 0.0)
    if bitwise:
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"{name}: not bitwise the plain version "
                                 f"(max |err| {err})")
    else:
        torch.testing.assert_close(got, want, **tol,
                                   msg=lambda m: f"{name}: {m}")
    return err


def kernel_phase(torch, np) -> dict:
    from repro_torch.core.lop import lop_features, pack_features
    from repro_torch.kernels import ref as plain
    from repro_torch.kernels.decode_attention import (
        fused_decode_attention, fused_dense_decode_attention)
    from repro_torch.kernels.decode_attention import \
        launch_shape as decode_launch_shape
    from repro_torch.kernels import _build
    from repro_torch.kernels.prefill_attention import fused_prefill_attention
    from repro_torch.kernels.prefill_attention import \
        launch_shape as prefill_launch_shape
    from repro_torch.kernels.qlinear import fused_ffn, fused_qlinear
    from repro_torch.kernels.qlinear import \
        launch_shape as qlinear_launch_shape

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    d, f, h, dh, m_cap, blk = 3200, 8640, 32, 100, 1664, 128
    rows = {}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # ---- #1 fused_qlinear: QKV and O at decode (m = 4) and chunk (128) ----
    log("  qlinear.cu: " + "; ".join(
        f"{kern} {ptxas_summary(_build, 'qlinear', kern)}"
        for kern in ("barrier_kernel", "qlinear_decode_kernel",
                     "qlinear_chunk_kernel", "gate_up_decode_kernel",
                     "gate_up_chunk_kernel")))
    err, timed = 0.0, None
    for label, m, k, n in (("qkv", 4, d, 3 * d), ("o", 4, d, d),
                           ("qkv", 128, d, 3 * d), ("o", 128, d, d)):
        x = t(rng.standard_normal((m, k)).astype(np.float32))
        packed = t(rng.integers(0, 256, (k // 4, n)).astype(np.uint8))
        gamma = t(rng.uniform(0.01, 0.05, (n,)).astype(np.float32))
        got = fused_qlinear(x, packed, gamma)
        want = plain.qlinear_ref(x, packed, gamma[None])
        err = max(err, check_close(torch, f"fused_qlinear[{label},m={m}]",
                                   got, want, bitwise=True))
        args = (x, packed, gamma)
        arg_sets = copies(torch, args)
        ms = cuda_ms(torch, fused_qlinear, arg_sets, 50)
        g_ms = graph_ms(torch, fused_qlinear, arg_sets)
        p_ms = cuda_ms(torch, lambda a, b, c: plain.qlinear_ref(a, b, c[None]),
                       [args], 3)
        b_ms, b_by = bound_ms(nbytes(x, packed, gamma) + m * n * 4,
                              int8_ops=2.0 * m * k * n)
        log(f"  fused_qlinear {label} m={m} k={k} n={n}: {ms:.4f} ms, in a "
            f"CUDA graph {g_ms:.4f} ms (plain {p_ms:.3f} ms, bound "
            f"{b_ms:.4f} ms by {b_by}; {b_ms / ms:.1%} of bound, "
            f"{b_ms / g_ms:.1%} in the graph) bitwise=True; GEMM "
            f"{fmt_shape(qlinear_launch_shape(m, k, n))}")
        if timed is None:
            timed = dict(ms=ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                         shape=f"{label} m={m} k={k} n={n}")
    rows["fused_qlinear"] = dict(timed, max_abs_err=err, library_ms=None)

    # ---- #2 fused_ffn at decode (m = 4) and chunk (128); then once at
    #      f 14,336 (mistral-nemo, above the former k cap) on a narrow d ----
    err, timed = 0.0, None
    for m, dd, ff in ((4, d, f), (128, d, f), (4, 256, 14336),
                      (128, 256, 14336)):
        x = t(rng.standard_normal((m, dd)).astype(np.float32))
        gu = t(rng.integers(0, 256, (dd // 4, 2 * ff)).astype(np.uint8))
        gs = t(rng.uniform(0.01, 0.05, (2 * ff,)).astype(np.float32))
        down = t(rng.integers(0, 256, (ff // 4, dd)).astype(np.uint8))
        ds = t(np.full((dd,), 0.02, np.float32))
        args = (x, gu, gs, down, ds)

        def kern(*a):
            return fused_ffn(*a, gated=True, act="silu")

        def ref(x_, gu_, gs_, down_, ds_):
            return plain.ffn_fused_ref(x_, gu_, gs_[None], down_, ds_[None],
                                       gated=True, act="silu")
        got, want = kern(*args), ref(*args)
        err = max(err, check_close(torch, f"fused_ffn[m={m},d={dd},f={ff}]",
                                   got, want))
        if ff != f:
            log(f"  fused_ffn m={m} d={dd} f={ff}: within rtol=atol="
                f"{TOL['rtol']} of the plain version, bitwise="
                f"{bool(torch.equal(got, want))} (check only)")
            continue
        arg_sets = copies(torch, args)
        ms = cuda_ms(torch, kern, arg_sets, 30)
        g_ms = graph_ms(torch, kern, arg_sets)
        p_ms = cuda_ms(torch, ref, [args], 3)
        b_ms, b_by = bound_ms(nbytes(*args) + m * d * 4,
                              int8_ops=2.0 * m * d * 2 * f + 2.0 * m * f * d)
        log(f"  fused_ffn m={m} d={d} f={f}: {ms:.4f} ms, in a CUDA graph "
            f"{g_ms:.4f} ms (plain {p_ms:.3f} ms, bound {b_ms:.4f} ms by "
            f"{b_by}; {b_ms / ms:.1%} of bound, {b_ms / g_ms:.1%} in the "
            f"graph) bitwise={bool(torch.equal(got, want))}; gate‖up GEMM "
            f"{fmt_shape(qlinear_launch_shape(m, d, f, gated=True))}, down "
            f"GEMM {fmt_shape(qlinear_launch_shape(m, f, d))}")
        if timed is None:
            timed = dict(ms=ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                         shape=f"m={m} d={d} f={f}")
    rows["fused_ffn"] = dict(timed, max_abs_err=err, library_ms=None)

    # ---- #3 fused_prefill_attention: last chunk of a 1536-token prompt,
    #      and the whole prompt, over the 1664-token capacity ----
    err, timed = 0.0, None
    s_total, c = 1536, 128
    k_c = t(rng.integers(-127, 128, (h, m_cap, dh)).astype(np.int8))
    v_c = t(rng.integers(-127, 128, (h, m_cap, dh)).astype(np.int8))
    ks = t((rng.random((h, m_cap)) * 0.02 + 0.001).astype(np.float32))
    vs = t((rng.random((h, m_cap)) * 0.02 + 0.001).astype(np.float32))
    scale = dh ** -0.5
    ptx = ptxas_summary(_build, "prefill_attention", "prefill_kernel")
    for label, r, q_off in (("chunk", c, s_total - c), ("whole", s_total, 0)):
        qi = t(rng.integers(-127, 128, (h, r, dh)).astype(np.int8))
        qsc = t((rng.random((h, r)) * 0.02 + 0.001).astype(np.float32))
        kv_len = torch.tensor([q_off + r], dtype=torch.int32, device=dev)
        args = (qi, qsc, k_c, v_c, ks, vs, kv_len, q_off)

        def kern(*a, window=0):
            return fused_prefill_attention(*a, hkv=h, chunk=a[0].shape[1],
                                           causal=True, window=window,
                                           softmax_scale=scale)

        def ref(qi_, qsc_, k_, v_, ks_, vs_, kvl_, qo_, window=0):
            return plain.prefill_attention_ref(
                qi_[None], qsc_[None], k_[None], v_[None], ks_[None],
                vs_[None], kvl_, qo_, causal=True, window=window,
                softmax_scale=scale)[0]
        got, want = kern(*args), ref(*args)
        err = max(err, check_close(torch, f"fused_prefill_attention[{label}]",
                                   got, want))
        if label == "whole":
            # chunked == whole bitwise at kernel level: 128-row chunks of
            # the same prompt over the same cache, each at its own q_off
            for start in range(0, s_total, c):
                part = kern(qi[:, start:start + c].contiguous(),
                            qsc[:, start:start + c].contiguous(), k_c, v_c,
                            ks, vs, torch.tensor([start + c], dtype=torch.int32,
                                                 device=dev), start)
                check_close(torch, f"fused_prefill_attention[chunk at "
                            f"{start}] vs whole", part,
                            got[:, start:start + c], bitwise=True)
            log(f"  fused_prefill_attention: {s_total // c} chunks of {c} "
                f"rows bitwise one whole call ({h} lanes, dh {dh})")
            # sliding window 512 over the whole prompt
            got_w = kern(*args, window=512)
            err = max(err, check_close(
                torch, "fused_prefill_attention[whole, window 512]", got_w,
                ref(*args, window=512)))
        ms = cuda_ms(torch, kern, copies(torch, args), 20)
        p_ms = cuda_ms(torch, ref, [args], 2)
        kvl = q_off + r
        visible = sum(q_off + i + 1 for i in range(r))      # causal pairs
        b_ms, b_by = bound_ms(
            nbytes(qi, qsc) + h * kvl * (2 * dh + 8) + h * r * dh * 4,
            int8_ops=2.0 * h * visible * dh, f32_ops=2.0 * h * visible * dh)
        # library yardstick: SDPA on the dequantized tensors, causal at the
        # chunk's offset (one PyTorch call, same function up to rounding)
        qf = (qi.float() * qsc[..., None])[None]
        kf = (k_c[:, :kvl].float() * ks[:, :kvl, None])[None]
        vf = (v_c[:, :kvl].float() * vs[:, :kvl, None])[None]
        mask = (torch.arange(kvl, device=dev)[None, :]
                <= (q_off + torch.arange(r, device=dev))[:, None])
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_ms = cuda_ms(torch, lambda a, b_, c_, m_: sdpa(a, b_, c_,
                                                          attn_mask=m_),
                         [(qf, kf, vf, mask)], 10)
        shape = prefill_launch_shape(h, r, dh)
        log(f"  fused_prefill_attention {label} R={r} q_off={q_off} M={m_cap}:"
            f" {ms:.4f} ms (plain {p_ms:.3f} ms, SDPA {lib_ms:.4f} ms, bound"
            f" {b_ms:.4f} ms by {b_by}; {b_ms / ms:.1%} of bound); "
            f"{shape['ctas']} CTAs x {shape['warps']} warps, "
            f"{shape['smem']} B dynamic smem; {ptx}")
        if timed is None:
            timed = dict(ms=ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib_ms,
                         shape=f"{label} R={r} q_off={q_off} M={m_cap} B=1")
    rows["fused_prefill_attention"] = dict(timed, max_abs_err=err)

    # ---- #4 fused_decode_attention: B = 4, M = 1664, k_keep = 2, one
    #      retired lane (new_len 0) ----
    b = 4
    bh = b * h
    k_keep = 2
    qi = t(rng.integers(-127, 128, (bh, 1, dh)).astype(np.int8))
    qsc = t((rng.random((bh, 1)) * 0.02 + 0.001).astype(np.float32))
    kd = t(rng.integers(-127, 128, (bh, m_cap, dh)).astype(np.int8))
    vd = t(rng.integers(-127, 128, (bh, m_cap, dh)).astype(np.int8))
    ksd = t((rng.random((bh, m_cap)) * 0.02 + 0.001).astype(np.float32))
    vsd = t((rng.random((bh, m_cap)) * 0.02 + 0.001).astype(np.float32))
    feat = pack_features(lop_features(kd))
    new_len = torch.tensor([1600, 0, 700, 1200], dtype=torch.int32,
                           device=dev)
    args = (qi, qsc, kd, vd, ksd, vsd, feat, new_len)
    scale = dh ** -0.5

    def kern(*a):
        return fused_decode_attention(*a, hkv=h, block=blk, k_keep=k_keep,
                                      window=0, softmax_scale=scale)

    def ref(qi_, qsc_, k_, v_, ks_, vs_, f_, nl_):
        out = plain.decode_attention_ref(
            qi_.reshape(b, h, dh), qsc_.reshape(b, h, 1),
            k_.reshape(b, h, m_cap, dh), v_.reshape(b, h, m_cap, dh),
            ks_.reshape(b, h, m_cap), vs_.reshape(b, h, m_cap),
            f_.reshape(b, h, m_cap, dh // 2), nl_, block=blk, k_keep=k_keep,
            window=0, softmax_scale=scale)
        return out.reshape(bh, 1, dh)
    got, want = kern(*args), ref(*args)
    err = check_close(torch, "fused_decode_attention", got, want)
    if got.reshape(b, h, dh)[1].any():
        raise AssertionError("fused_decode_attention: retired lane not zero")
    arg_sets = copies(torch, args)
    ms = cuda_ms(torch, kern, arg_sets, 50)
    g_ms = graph_ms(torch, kern, arg_sets)
    p_ms = cuda_ms(torch, ref, [args], 3)
    nl = new_len.tolist()
    live_tok = sum(min(n_, k_keep * blk) for n_ in nl if n_)  # ≤ K blocks
    sel_blocks = sum(min(k_keep, -(-n_ // blk)) for n_ in nl if n_)
    b_ms, b_by = bound_ms(
        nbytes(qi, qsc, new_len) + h * sum(nl) * (dh // 2)
        + h * sel_blocks * blk * (2 * dh + 8) + bh * dh * 4,
        int8_ops=2.0 * h * (sum(nl) + live_tok) * dh,
        f32_ops=2.0 * h * live_tok * dh)
    kind = "ILb1EE"                  # the instance <kOne = one query row>
    log(f"  fused_decode_attention B={b} M={m_cap} k_keep={k_keep}: "
        f"{ms:.4f} ms, in a CUDA graph {g_ms:.4f} ms (plain {p_ms:.3f} ms, "
        f"bound {b_ms:.4f} ms by {b_by}; {b_ms / ms:.1%} of bound, "
        f"{b_ms / g_ms:.1%} in the graph); "
        f"{fmt_decode_shape(decode_launch_shape(bh, 1, m_cap, dh, blk, k_keep=k_keep))}"
        f"; {ptxas_summary(_build, 'decode_attention', 'lop_decode_kernel' + kind)}")
    rows["fused_decode_attention"] = dict(
        ms=ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        max_abs_err=err, shape=f"B={b} H=32 M={m_cap} k_keep={k_keep}")

    # ---- #5 fused_dense_decode_attention: the same inputs, every valid
    #      token attended (the --no-lop and recovery-retry path) ----
    dargs = (qi, qsc, kd, vd, ksd, vsd, new_len)

    def dkern(*a):
        return fused_dense_decode_attention(*a, hkv=h, block=blk, window=0,
                                            softmax_scale=scale)

    def dref(qi_, qsc_, k_, v_, ks_, vs_, nl_):
        out = plain.decode_attention_ref(
            qi_.reshape(b, h, dh), qsc_.reshape(b, h, 1),
            k_.reshape(b, h, m_cap, dh), v_.reshape(b, h, m_cap, dh),
            ks_.reshape(b, h, m_cap), vs_.reshape(b, h, m_cap), None, nl_,
            block=blk, k_keep=k_keep, window=0, softmax_scale=scale,
            use_lop=False)
        return out.reshape(bh, 1, dh)
    got, want = dkern(*dargs), dref(*dargs)
    derr = check_close(torch, "fused_dense_decode_attention", got, want)
    if got.reshape(b, h, dh)[1].any():
        raise AssertionError("fused_dense_decode_attention: retired lane "
                             "not zero")
    arg_sets = copies(torch, dargs)
    d_ms = cuda_ms(torch, dkern, arg_sets, 50)
    dg_ms = graph_ms(torch, dkern, arg_sets)
    dp_ms = cuda_ms(torch, dref, [dargs], 3)
    db_ms, db_by = bound_ms(
        nbytes(qi, qsc, new_len) + h * sum(nl) * (2 * dh + 8) + bh * dh * 4,
        int8_ops=2.0 * h * sum(nl) * dh, f32_ops=2.0 * h * sum(nl) * dh)
    # library yardstick: SDPA over the dequantized f32 K/V with the
    # validity mask (one PyTorch call, same function up to rounding; the
    # retired lane's fully masked row is NaN there, zero in the kernel)
    qf = (qi.float() * qsc[..., None])[:, None]           # [BH, 1, 1, dh]
    kf = (kd.float() * ksd[..., None])[:, None]           # [BH, 1, M, dh]
    vf = (vd.float() * vsd[..., None])[:, None]
    lane_len = new_len.repeat_interleave(h)
    mask = (torch.arange(m_cap, device=dev)[None, :]
            < lane_len[:, None])[:, None, None, :]        # [BH, 1, 1, M]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = cuda_ms(torch, lambda a, b_, c_, m_: sdpa(a, b_, c_,
                                                      attn_mask=m_),
                     [(qf, kf, vf, mask)], 20)
    log(f"  fused_dense_decode_attention B={b} M={m_cap} new_len={nl}: "
        f"{d_ms:.4f} ms, in a CUDA graph {dg_ms:.4f} ms (plain {dp_ms:.3f} "
        f"ms, SDPA {lib_ms:.4f} ms, bound {db_ms:.4f} ms by {db_by}; "
        f"{db_ms / d_ms:.1%} of bound, {db_ms / dg_ms:.1%} in the graph); "
        f"{fmt_decode_shape(decode_launch_shape(bh, 1, m_cap, dh, blk, lop=False))}"
        f"; {ptxas_summary(_build, 'decode_attention', 'dense_decode_kernel' + kind)}"
        f"; LOP at the same shape: {ms:.4f} ms (graph {g_ms:.4f} ms), bound "
        f"{b_ms:.4f} ms")
    rows["fused_dense_decode_attention"] = dict(
        ms=d_ms, plain_ms=dp_ms, bound_ms=db_ms, bound_by=db_by,
        library_ms=lib_ms, max_abs_err=derr,
        shape=f"B={b} H=32 M={m_cap} new_len={nl}")
    return rows


# ---------------------------------------------------------------------------
# phase 4: serve full-width bitnet-3b
# ---------------------------------------------------------------------------

LOP_PATH = ("fused_qlinear", "fused_ffn", "fused_prefill_attention",
            "fused_decode_attention")
DENSE = "fused_dense_decode_attention"


def serve_run(torch, np, engine, reqs, label: str, card: str, **sched_kw):
    """Serve ``reqs`` through a Scheduler on ``engine`` with the launch
    counts zeroed just before and read just after. → dict."""
    from repro_torch.kernels import ops
    from repro_torch.serving.scheduler import Scheduler

    sched = Scheduler(engine, n_slots=N_SLOTS, **sched_kw)
    if sched.capacity != 1664:
        raise AssertionError(f"pool capacity {sched.capacity} != 1664")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.monotonic()
    for r in reqs:
        sched.submit(r)
    results = {r.rid: r for r in sched.run_to_completion()}
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"  [{label}] launch counts (graph replays counted): {counts}")
    if sorted(results) != sorted(r.rid for r in reqs):
        raise AssertionError(f"[{label}] finished rids {sorted(results)}")
    n_tok = sum(len(r.tokens) for r in results.values())
    log(f"  [{label}] tokens sha256 {tokens_digest(results)}")
    ttft = [r.ttft for r in results.values()]
    step_ms = float(np.percentile(sched.decode_seconds, 50) * 1e3)
    log(f"  [{label}] served {len(reqs)} requests, {n_tok} tokens in "
        f"{wall:.3f} s: {n_tok / wall:.2f} tok/s, TTFT p50 "
        f"{np.percentile(ttft, 50) * 1e3:.1f} ms, serve-cycle decode p50 "
        f"{step_ms:.2f} ms over {sched.decode_steps} steps (waits on the "
        f"cycle's prefill chunk), max_memory_allocated "
        f"{peak / 2**30:.2f} GiB; {graph_memory(engine)} [{card}]")
    return dict(sched=sched, results=results, counts=counts,
                tokens_per_s=n_tok / wall,
                ttft_p50_ms=float(np.percentile(ttft, 50) * 1e3),
                serve_cycle_decode_ms_p50=step_ms, peak_bytes=peak)


def graph_memory(engine) -> str:
    graphs = engine.graphs
    if graphs is None:
        return "no CUDA graphs (eager)"
    return (f"{graphs.count} CUDA graphs held ({len(graphs)} keys), "
            f"{graphs.nbytes / 2**20:.1f} MiB reserved by their captures")


def tokens_digest(results: dict) -> str:
    """sha256 (16 hex digits) of every request's tokens in rid order: the
    same digest on two builds means the same tokens."""
    text = json.dumps([[rid, [int(x) for x in results[rid].tokens]]
                       for rid in sorted(results)])
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def check_counts(counts: dict, label: str, launched, idle=()) -> None:
    missing = [k for k in launched if counts[k] <= 0]
    if missing:
        raise AssertionError(f"[{label}] kernels not launched: {missing}")
    stray = [k for k in idle if counts[k] != 0]
    if stray:
        raise AssertionError(f"[{label}] kernels launched that this path "
                             f"must not run: {stray}")


def check_tokens(cfg, results, gen: int, label: str) -> None:
    for r in results.values():
        if r.finish_reason != "length" or len(r.tokens) != gen or not all(
                0 <= x < cfg.vocab_padded for x in r.tokens):
            raise AssertionError(f"[{label}] rid {r.rid}: "
                                 f"{r.finish_reason} {r.tokens}")


def graph_pool_bytes(torch) -> int:
    """Device memory in the caching allocator's private pools — the CUDA
    graphs' — once what is free has been released."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) != (0, 0))


def check_lockstep(engine, reqs, results, rids, label: str) -> None:
    import torch
    from repro_torch.serving.graphs import GRAPH_BOUND
    from repro_torch.serving.scheduler import lockstep_generate
    graphs = engine.graphs
    if graphs is None:
        raise AssertionError(f"[{label}] the engine holds no CUDA graphs")
    pools, held = graph_pool_bytes(torch), graphs.nbytes
    for rid in rids:
        req = reqs[rid]
        ref = lockstep_generate(engine, req.prompt, req.max_new_tokens,
                                sampling=req.sampling)
        if ref != results[rid].tokens:
            raise AssertionError(f"[{label}] rid {rid}: scheduler "
                                 f"{results[rid].tokens} != lockstep {ref}")
    grew = graph_pool_bytes(torch) - pools
    if len(graphs) > GRAPH_BOUND or grew != graphs.nbytes - held:
        raise AssertionError(
            f"[{label}] graph memory: pools grew {grew} B, held graphs "
            f"{graphs.nbytes - held} B; {graph_memory(engine)}, bound "
            f"{GRAPH_BOUND}")
    log(f"  [{label}] scheduler tokens == lockstep tokens for rids "
        f"{', '.join(map(str, rids))} (a fresh cache each; graph pools grew "
        f"{grew / 2**20:.1f} MiB, as the held graphs did; "
        f"{graph_memory(engine)}, bound {GRAPH_BOUND})")


def serve_phase(torch, np, card: str):
    """Phase 4: the greedy LOP serve. → (engine, reqs, stats)."""
    from repro_torch.configs import get_config
    from repro_torch.serving.api import GenerateRequest, PooledEngine
    from repro_torch.serving.scheduler import Scheduler
    from repro_torch.launch.serve import make_requests

    cfg = get_config("bitnet-3b")
    max_len = MAX_PROMPT + GEN
    t0 = time.monotonic()
    engine = PooledEngine.from_seed(cfg, seed=SEED, max_len=max_len,
                                    device="cuda")
    torch.cuda.synchronize()
    log(f"  seeded bitnet-3b weights ready in {time.monotonic() - t0:.1f} s")
    reqs = make_requests(cfg, n_requests=N_REQUESTS, min_prompt=MIN_PROMPT,
                         max_prompt=MAX_PROMPT, gen=GEN, seed=SEED)
    log("  prompt lengths: " + ", ".join(str(len(r.prompt)) for r in reqs))

    # warm-up (library handles, allocator) on a short request
    warm = Scheduler(engine, n_slots=1)
    warm.submit(GenerateRequest(rid=-1, prompt=reqs[0].prompt[:64],
                                max_new_tokens=2))
    warm.run_to_completion()
    del warm

    run = serve_run(torch, np, engine, reqs, "LOP greedy", card)
    check_counts(run["counts"], "LOP greedy", LOP_PATH, idle=(DENSE,))
    check_tokens(cfg, run["results"], GEN, "LOP greedy")
    check_lockstep(engine, reqs, run["results"], (0, 1), "LOP greedy")

    # chunked prefill vs whole-prompt prefill, bitwise
    prompt = max((r.prompt for r in reqs), key=len)
    logits_w, whole = engine.prefill(prompt[None])
    chk = Scheduler(engine, n_slots=1)
    chk.submit(GenerateRequest(rid=0, prompt=prompt, max_new_tokens=1))
    chk.admit()
    pf = chk._prefilling[0]
    for kk in range(len(pf.chunks)):
        logits_c, pool = engine.prefill_chunk(
            chk.pool, pf.slot, pf.chunks[kk], pf.starts[kk], pf.seq_ends[kk],
            kk == len(pf.chunks) - 1)
    s = len(prompt)
    if not torch.isfinite(logits_w).all():
        raise AssertionError("non-finite prefill logits")
    if not torch.equal(logits_c, logits_w):
        raise AssertionError("chunked prefill logits != whole-prompt logits")
    for key, leaf in whole["layers"].items():
        if not torch.equal(pool["layers"][key][:, 0, :, :s], leaf[:, 0, :, :s]):
            raise AssertionError(f"chunked prefill cache '{key}' != whole")
    log(f"  chunked prefill ({len(pf.chunks)} chunks) == whole-prompt "
        f"prefill, bitwise, for a {s}-token prompt")
    del chk, pool, whole
    steady = steady_phase(torch, np, engine, reqs, card)
    stats = {k: v for k, v in run.items() if k not in ("sched", "results")}
    return engine, reqs, dict(stats, **steady)


def decode_step_ms(torch, np, engine, reqs, sampling=None):
    """p50 of 10 decode steps over 4 active lanes with no prefill in flight
    (host clock around work that ends in a synchronize). → (ms, sched)."""
    from dataclasses import replace

    from repro_torch.serving.scheduler import Scheduler

    sched = Scheduler(engine, n_slots=N_SLOTS)
    for r in reqs[:N_SLOTS]:
        sched.submit(replace(r, max_new_tokens=96, arrival=None,
                             **({} if sampling is None
                                else dict(sampling=sampling(r.rid)))))
    sched.admit()
    while sched.n_prefilling:
        sched.step()
    if sched.n_active != N_SLOTS:
        raise AssertionError(f"{sched.n_active} lanes active, want {N_SLOTS}")
    from repro_torch.kernels import ops
    step_s = []
    ops.reset_launch_counts()
    for _ in range(12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sched.step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    check_step_counts(ops.launch_counts(), engine, len(step_s))
    return float(np.median(step_s[2:]) * 1e3), sched


def check_step_counts(counts: dict, engine, steps: int) -> None:
    """Each decode step launches #1 twice a layer (QKV, O), #2 once and
    its decode kernel once, and nothing else — counted per graph replay as
    per eager call."""
    n = engine.cfg.n_layers
    attn = "fused_decode_attention" if engine.use_lop else DENSE
    want = {"fused_qlinear": 2 * n * steps, "fused_ffn": n * steps,
            attn: n * steps}
    got = {k: v for k, v in counts.items() if v}
    if got != want:
        raise AssertionError(f"{steps} decode steps launched {got}, want "
                             f"{want}")


def decode_arms(torch, np, engine, reqs, label: str, card: str,
                sampling=None) -> dict:
    """The clean decode step on an eager twin of ``engine`` (the same
    weights, ``graphs=False``) and on ``engine``'s CUDA graphs, one after
    the other: both lanes' tokens must agree. → dict of both p50s and
    schedulers."""
    from repro_torch.serving.api import PooledEngine

    eager = PooledEngine(engine.cfg, engine.qp, max_len=engine.max_len,
                         use_lop=engine.use_lop, device="cuda", graphs=False)
    eager_ms, eager_sched = decode_step_ms(torch, np, eager, reqs, sampling)
    graph_ms_, sched = decode_step_ms(torch, np, engine, reqs, sampling)
    want = [lane.tokens for lane in eager_sched.lanes]
    if [lane.tokens for lane in sched.lanes] != want:
        raise AssertionError(f"[{label}] graph decode tokens != eager")
    log(f"  decode step (B={N_SLOTS}, no prefill in flight), {label}: "
        f"p50 eager {eager_ms:.2f} ms, CUDA graph {graph_ms_:.2f} ms over "
        f"10 steps each, tokens equal; {graph_memory(engine)} [{card}]")
    return dict(ms=graph_ms_, eager_ms=eager_ms, sched=sched,
                eager_sched=eager_sched)


def profile_arms(torch, arms: dict, label: str, card: str) -> dict:
    """Profile 4 decode steps on each arm of :func:`decode_arms`. → device
    ms a step and busy share of each."""
    out = {}
    for arm, sched in (("eager", arms["eager_sched"]),
                       ("graph", arms["sched"])):
        dev_us, wall_us = profile_steps(torch, sched, f"{label}, {arm}")
        out[arm] = ((dev_us / 4e3, dev_us / wall_us) if dev_us
                    else (None, None))
    (e_ms, e_busy), (g_ms, g_busy) = out["eager"], out["graph"]
    if e_ms and g_ms:
        log(f"  device time a step, {label}: eager {e_ms:.3f} ms, CUDA "
            f"graph {g_ms:.3f} ms ({g_ms / e_ms - 1:+.1%}); busy eager "
            f"{e_busy:.1%}, graph {g_busy:.1%} (profiler on) [{card}]")
    return out


def nolop_phase(torch, np, engine, reqs, card: str) -> dict:
    """Phase 4b: the same 8 requests on a use_lop=False engine sharing the
    LOP engine's quantized weights."""
    from repro_torch.serving.api import PooledEngine

    dense = PooledEngine(engine.cfg, engine.qp, max_len=engine.max_len,
                         use_lop=False, device="cuda")
    run = serve_run(torch, np, dense, reqs, "no-LOP greedy", card)
    check_counts(run["counts"], "no-LOP greedy",
                 ("fused_qlinear", "fused_ffn", "fused_prefill_attention",
                  DENSE), idle=("fused_decode_attention",))
    check_tokens(engine.cfg, run["results"], GEN, "no-LOP greedy")
    check_lockstep(dense, reqs, run["results"], (0, 1), "no-LOP greedy")
    run.pop("sched")
    arms = decode_arms(torch, np, dense, reqs, "no-LOP greedy", card)
    prof = profile_arms(torch, arms, "no-LOP greedy", card)
    return dict(dense=dense, counts=run["counts"],
                tokens_per_s=run["tokens_per_s"],
                ttft_p50_ms=run["ttft_p50_ms"], decode_step_ms_p50=arms["ms"],
                eager_decode_step_ms_p50=arms["eager_ms"],
                device_ms=prof["graph"][0], eager_device_ms=prof["eager"][0])


def sampled_fault_phase(torch, np, engine, dense, reqs, card: str) -> dict:
    """Phase 4c: sampled serve, then the fault-recovery, sticky-fault,
    deadline and cancellation contracts on the card."""
    from dataclasses import replace

    from repro_torch.kernels import ops
    from repro_torch.serving import faults
    from repro_torch.serving.api import (CancelToken, GenerateRequest,
                                         SamplingParams)
    from repro_torch.serving.scheduler import Scheduler

    cfg = engine.cfg

    def sp(rid):
        return SamplingParams(temperature=0.8, top_k=50, top_p=0.95,
                              seed=rid)

    # 1. sampled LOP serve == sampled lockstep
    sreqs = [replace(r, sampling=sp(r.rid)) for r in reqs]
    run = serve_run(torch, np, engine, sreqs, "LOP sampled", card)
    check_counts(run["counts"], "LOP sampled", LOP_PATH, idle=(DENSE,))
    check_tokens(cfg, run["results"], GEN, "LOP sampled")
    check_lockstep(engine, sreqs, run["results"], (0, 1), "LOP sampled")
    sampled_tps = run["tokens_per_s"]
    del run                       # its pool would count in later peaks
    arms = decode_arms(torch, np, engine, reqs,
                       "LOP sampled (T=0.8, top_k=50, top_p=0.95)", card,
                       sampling=sp)
    sampled_ms, sampled_eager_ms = arms["ms"], arms["eager_ms"]
    del arms                      # their pools would count in later peaks

    # 2. transient NaNs on the no-LOP engine recover to the clean streams
    freqs = [replace(r, max_new_tokens=16) for r in reqs[:N_SLOTS]]
    dense_launches = 0
    streams = []
    for plan in (faults.FaultPlan(),
                 faults.FaultPlan(nan_logits=frozenset({(3, 0), (7, 2)}))):
        frun = None                   # free the last run's pool first
        with faults.inject(plan):
            frun = serve_run(torch, np, dense, freqs,
                             f"no-LOP faults={sorted(plan.nan_logits)}", card,
                             check_invariants=True)
        dense_launches += frun["counts"][DENSE]
        streams.append({rid: r.tokens for rid, r in frun["results"].items()})
    fs = frun["sched"]
    if not (fs.fault_events >= 1 and fs.fault_recoveries == fs.fault_events
            and fs.fault_finishes == 0):
        raise AssertionError(f"fault run: events {fs.fault_events}, "
                             f"recoveries {fs.fault_recoveries}, finishes "
                             f"{fs.fault_finishes}")
    if streams[0] != streams[1]:
        raise AssertionError("recovered streams != clean streams")
    log(f"  transient NaNs: {fs.fault_events} events, "
        f"{fs.fault_recoveries} recovered, 0 gave up; every stream bitwise "
        f"the clean run's")

    # 3.-4. sticky fault, deadline, cancellation
    ops.reset_launch_counts()
    short = reqs[0].prompt[:200]
    with faults.inject(faults.FaultPlan(sticky_nan_lanes=frozenset({0}))):
        sticky = Scheduler(dense, n_slots=1, check_invariants=True)
        sticky.submit(GenerateRequest(rid=0, prompt=short, max_new_tokens=8))
        (res,) = sticky.run_to_completion()
    if res.finish_reason != "fault" or sticky.fault_finishes != 1:
        raise AssertionError(f"sticky lane finished {res.finish_reason}")
    tok = CancelToken()

    def cancel_at_two(sr):
        if sr.index == 2:
            tok.cancel()

    ab = Scheduler(engine, n_slots=2, check_invariants=True)
    ab.submit(GenerateRequest(rid=0, prompt=short, max_new_tokens=16,
                              deadline_ms=1e-3))
    ab.submit(GenerateRequest(rid=1, prompt=short, max_new_tokens=16,
                              on_token=cancel_at_two, cancel=tok))
    got = {r.rid: r for r in ab.run_to_completion()}
    if (got[0].finish_reason, got[0].tokens) != ("deadline", []) \
            or got[1].finish_reason != "cancelled" \
            or len(got[1].tokens) != 3 or ab.deadline_count != 1:
        raise AssertionError(f"deadline/cancel: {got[0].finish_reason} "
                             f"{got[0].tokens}, {got[1].finish_reason} "
                             f"{got[1].tokens}")
    dense_launches += ops.launch_counts()[DENSE]
    log("  sticky lane -> fault; 1 us deadline -> deadline, no tokens; "
        "cancel after the 3rd token -> cancelled with 3 tokens")

    # 5. the production shape: a LOP server whose retry runs dense; enough
    #    events on one pool that the retry's graph is captured and replayed
    ops.reset_launch_counts()
    with faults.inject(faults.FaultPlan(nan_logits=frozenset({
            (3, 0), (7, 2), (12, 1), (20, 2), (28, 3)}))):
        lop_faults = Scheduler(engine, n_slots=N_SLOTS, check_invariants=True)
        for r in freqs:
            lop_faults.submit(replace(r, arrival=None))
        lres = lop_faults.run_to_completion()
    counts = ops.launch_counts()
    dense_launches += counts[DENSE]
    if not (lop_faults.fault_events >= 1 and lop_faults.fault_finishes == 0
            and lop_faults.fault_recoveries == lop_faults.fault_events):
        raise AssertionError(f"LOP fault run: events "
                             f"{lop_faults.fault_events}, finishes "
                             f"{lop_faults.fault_finishes}")
    if any(r.finish_reason != "length" for r in lres):
        raise AssertionError("LOP fault run: a request did not finish")
    retries = lop_faults.fault_events
    if retries < 3:
        raise AssertionError(f"LOP fault run: {retries} retries, want >= 3 "
                             f"(warm-up, capture, replays)")
    if counts[DENSE] != cfg.n_layers * retries:
        raise AssertionError(f"dense launches {counts[DENSE]} != "
                             f"{cfg.n_layers} x {retries} retries")
    log(f"  LOP engine under NaN faults: {lop_faults.fault_events} events, "
        f"all recovered through the dense retry ({counts[DENSE]} dense "
        f"launches = {cfg.n_layers} layers x {retries} retries; the "
        f"retry's graph warmed once, then captured and replayed)")
    return dict(sampled_tokens_per_s=sampled_tps,
                sampled_decode_step_ms_p50=sampled_ms,
                sampled_eager_decode_step_ms_p50=sampled_eager_ms,
                dense_launches=dense_launches)


# ---------------------------------------------------------------------------
# phase 5: the standalone kernels and the per-head LOP decode
# ---------------------------------------------------------------------------

STANDALONE = ("ternary_matmul", "lop_scores_kernel", "int8_flash_prefill",
              "sparse_decode_attention")
TINT_SHAPES = (("qkv", 3200, 9600), ("o", 3200, 3200),
               ("gate_up", 3200, 17280), ("down", 8640, 3200))
PER_HEAD_LEN = (1600, 1, 700, 1200)


def cache_lanes(torch, np, engine) -> dict:
    """K/V, scales and LOP features of the last layer for 4 lanes, each a
    whole-prompt prefill of a seeded prompt of PER_HEAD_LEN tokens on the
    serve engine. → {leaf: [B, Hkv, M, ...]}."""
    cfg = engine.cfg
    rng = np.random.default_rng(SEED + 13)
    leaves = {key: [] for key in ("k", "v", "k_scale", "v_scale", "feat")}
    for n in PER_HEAD_LEN:
        prompt = rng.integers(0, cfg.vocab, n).astype(np.int32)
        _, cache = engine.prefill(prompt[None])
        for key, vals in leaves.items():
            vals.append(cache["layers"][key][cfg.n_layers - 1, 0].clone())
        del cache
    return {key: torch.stack(vals) for key, vals in leaves.items()}


def time_row(torch, kern, ref, args, n_iter, b_ms, b_by, lib):
    """Time ``kern`` (L2 cold) and ``ref`` on ``args``, and the library
    call ``lib = (fn, its args)`` (L2 cold). → the row fields."""
    fn, lib_args = lib
    return dict(ms=cuda_ms(torch, kern, copies(torch, args), n_iter),
                plain_ms=cuda_ms(torch, ref, [args], 3),
                library_ms=cuda_ms(torch, fn, copies(torch, lib_args),
                                   n_iter),
                bound_ms=b_ms, bound_by=b_by)


def fmt_row(row) -> str:
    return (f"{row['ms']:.4f} ms (plain {row['plain_ms']:.3f} ms, library "
            f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms by "
            f"{row['bound_by']})")


def standalone_kernels(torch, np, lanes, card) -> dict:
    """Part 1: each standalone kernel against its plain version on the
    card, at full width, with its times. → rows by kernel name."""
    from repro_torch.core.lop import features_to_pot, pot, unpack_features
    from repro_torch.core.ternary import unpack_ternary
    from repro_torch.kernels import ref as plain
    from repro_torch.kernels import _build
    from repro_torch.kernels.int8_attention import (
        flash_prefill_launch_shape, int8_flash_prefill,
        sparse_decode_attention, sparse_decode_launch_shape)
    from repro_torch.kernels.lop_scores import launch_shape as \
        lop_launch_shape
    from repro_torch.kernels.lop_scores import lop_scores_kernel
    from repro_torch.kernels.ternary_matmul import launch_shape as \
        tint_launch_shape
    from repro_torch.kernels.ternary_matmul import ternary_matmul
    from repro_torch.serving.lop_select import select_blocks

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 14)
    rows = {}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # ---- #7 ternary_matmul: the four projections at m = 4 and 128 ----
    log(f"  ternary_matmul: decode kernel {ptxas_summary(_build, 'ternary_matmul', 'ternary_matmul_decode_kernel')}; "
        f"chunk kernel {ptxas_summary(_build, 'ternary_matmul', 'ternary_matmul_chunk_kernel')}")
    err, first = 0.0, None
    for m in (4, 128):
        for label, k, n in TINT_SHAPES:
            x = t(rng.integers(-127, 128, (m, k)).astype(np.int8))
            packed = t(rng.integers(0, 256, (k // 4, n)).astype(np.uint8))
            got = ternary_matmul(x, packed)
            want = plain.ternary_matmul_ref(x, packed, k)
            err = max(err, check_close(torch, f"ternary_matmul[{label},m={m}]",
                                       got, want, bitwise=True))
            # library yardstick: torch._int_mm on the unpacked int8 weight
            # (4x the weight bytes); it wants more than 16 rows, so m = 4
            # is padded to 32
            w8 = unpack_ternary(packed, k)
            x_pad = torch.zeros((max(m, 32), k), dtype=torch.int8,
                                device=dev)
            x_pad[:m] = x
            if not torch.equal(torch._int_mm(x_pad, w8)[:m], want):
                raise AssertionError("torch._int_mm disagrees with the "
                                     "plain TINT GEMM")
            b_ms, b_by = bound_ms(nbytes(x, packed) + m * n * 4,
                                  int8_ops=2.0 * m * k * n)
            row = time_row(torch, ternary_matmul,
                           lambda a, b: plain.ternary_matmul_ref(a, b, k),
                           (x, packed), 50, b_ms, b_by,
                           lib=(torch._int_mm, (x_pad, w8)))
            g_ms = graph_ms(torch, ternary_matmul, copies(torch, (x, packed)))
            log(f"  ternary_matmul {label} m={m} k={k} n={n}: {fmt_row(row)}"
                f" bitwise=True{' (_int_mm at 32 rows)' if m < 32 else ''}; "
                f"in a CUDA graph {g_ms:.4f} ms; {b_ms / row['ms']:.1%} of "
                f"bound ({b_ms / g_ms:.1%} in the graph); "
                f"{fmt_shape(tint_launch_shape(m, k, n))} [{card}]")
            if first is None:
                first = dict(row, shape=f"{label} m={m} k={k} n={n}")
    # check only: k above the former 13,952 cap (qwen1.5-32b's down
    # projection)
    k, n = 27392, 5120
    for m in (4, 128):
        x = t(rng.integers(-127, 128, (m, k)).astype(np.int8))
        packed = t(rng.integers(0, 256, (k // 4, n)).astype(np.uint8))
        err = max(err, check_close(
            torch, f"ternary_matmul[k={k},n={n},m={m}]", ternary_matmul(
                x, packed), plain.ternary_matmul_ref(x, packed, k),
            bitwise=True))
        log(f"  ternary_matmul m={m} k={k} n={n}: bitwise=True (check only)")
        del x, packed
    rows["ternary_matmul"] = dict(first, max_abs_err=err)

    # ---- #6 lop_scores_kernel: every (B, Hkv) lane of the cache ----
    b, hkv, m_cap, dh = lanes["k"].shape
    n_lanes = b * hkv
    qi = t(rng.integers(-127, 128, (b, hkv, dh)).astype(np.int8))
    q_pot = pot(qi).reshape(n_lanes, 1, dh)
    feat = lanes["feat"].reshape(n_lanes, m_cap, dh // 2)
    got = lop_scores_kernel(q_pot, feat)
    want = plain.lop_scores_ref(q_pot, feat)
    err = check_close(torch, "lop_scores_kernel", got, want, bitwise=True)
    # library yardstick: one batched f32 product of the unpacked pot
    # operands (exact: |score| < 2^24); _int_mm is 2-D and has no lanes
    k_pot = features_to_pot(unpack_features(feat)).float().transpose(1, 2)
    q_f = q_pot.float()
    if not torch.equal(torch.bmm(q_f, k_pot).to(torch.int32), want):
        raise AssertionError("torch.bmm disagrees with the plain LOP screen")
    b_ms, b_by = bound_ms(nbytes(q_pot, feat) + n_lanes * m_cap * 4,
                          int8_ops=2.0 * n_lanes * m_cap * dh)
    row = time_row(torch, lop_scores_kernel,
                   plain.lop_scores_ref, (q_pot, feat), 50, b_ms, b_by,
                   lib=(torch.bmm, (q_f, k_pot)))
    g_ms = graph_ms(torch, lop_scores_kernel, copies(torch, (q_pot, feat)))
    shape = lop_launch_shape(n_lanes, 1, m_cap, dh)
    log(f"  lop_scores_kernel lanes={n_lanes} g=1 M={m_cap} d={dh}: "
        f"{fmt_row(row)} bitwise=True (library: torch.bmm, f32 pot); in a "
        f"CUDA graph {g_ms:.4f} ms; {b_ms / row['ms']:.1%} of bound "
        f"({b_ms / g_ms:.1%} in the graph); {shape['ctas']} CTAs x "
        f"{shape['warps']} warps ({shape['tiles']} tiles of "
        f"{shape['tokens']} tokens a lane), {shape['smem']} B dynamic smem; "
        f"{ptxas_summary(_build, 'lop_scores', 'lop_scores_kernel')} [{card}]")
    rows["lop_scores_kernel"] = dict(row, max_abs_err=err,
                                     shape=f"lanes={n_lanes} g=1 M={m_cap} "
                                           f"d={dh}")

    # ---- #8 int8_flash_prefill: one head of 1536 tokens ----
    s_len = 1536
    sm = dh ** -0.5
    q8, k8, v8 = (t(rng.integers(-127, 128, (s_len, dh)).astype(np.int8))
                  for _ in range(3))
    qs8, ks8, vs8 = (t(rng.uniform(0.001, 0.02, (s_len, 1)).astype(
        np.float32)) for _ in range(3))
    args8 = (q8, k8, v8, qs8, ks8, vs8)
    err = 0.0
    for causal, window in ((True, 0), (True, 512), (False, 0)):
        kw = dict(softmax_scale=sm, causal=causal, window=window)
        got = int8_flash_prefill(*args8, **kw)
        want = plain.flash_prefill_ref(*args8, **kw)
        err = max(err, check_close(
            torch, f"int8_flash_prefill[causal={causal},window={window}]",
            got, want, tol=TOL_STANDALONE))
    pairs = s_len * (s_len + 1) / 2
    b_ms, b_by = bound_ms(nbytes(*args8) + s_len * dh * 4,
                          int8_ops=2.0 * pairs * dh, f32_ops=2.0 * pairs * dh)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qf, kf, vf = ((a.float() * sc)[None, None]
                  for a, sc in ((q8, qs8), (k8, ks8), (v8, vs8)))
    kw = dict(softmax_scale=sm, causal=True)
    row = time_row(torch, lambda *a: int8_flash_prefill(*a, **kw),
                   lambda *a: plain.flash_prefill_ref(*a, **kw), args8, 20,
                   b_ms, b_by,
                   lib=(lambda a, b_, c: sdpa(a, b_, c, is_causal=True),
                        (qf, kf, vf)))
    shape = flash_prefill_launch_shape(s_len, dh)
    log(f"  int8_flash_prefill s={s_len} d={dh} causal: {fmt_row(row)}, "
        f"{b_ms / row['ms']:.1%} of bound; {shape['ctas']} CTAs of 16 rows x "
        f"{shape['warps']} warps on 132 SMs, {shape['smem']} B dynamic smem; "
        f"{ptxas_summary(_build, 'int8_attention', 'flash_prefill_kernel')}; "
        f"SWA 512 and non-causal checked too (library: SDPA on dequantized "
        f"f32) [{card}]")
    rows["int8_flash_prefill"] = dict(row, max_abs_err=err,
                                      shape=f"s={s_len} d={dh} causal")

    # ---- #9 sparse_decode_attention: the per-head path's selections ----
    new_len = torch.tensor(PER_HEAD_LEN, dtype=torch.int32, device=dev)
    scores = plain.lop_scores_ref(q_pot, feat).reshape(b, hkv, 1, m_cap)
    blk = 128
    idx, gt = select_blocks(scores, new_len, block=blk, k_keep=2)
    nb = idx.shape[-1]
    q9, k9, v9 = (qi.reshape(n_lanes, 1, dh),
                  lanes["k"].reshape(n_lanes, m_cap, dh),
                  lanes["v"].reshape(n_lanes, m_cap, dh))
    qs9 = t(rng.uniform(0.001, 0.02, (n_lanes, 1, 1)).astype(np.float32))
    ks9, vs9 = (lanes[key].reshape(n_lanes, m_cap, 1)
                for key in ("k_scale", "v_scale"))
    idx9 = idx.reshape(n_lanes, nb).contiguous()
    gt9 = gt.reshape(n_lanes, 3 * nb).contiguous()
    args9 = (q9, k9, v9, qs9, ks9, vs9, idx9, gt9)
    kw = dict(block=blk, softmax_scale=sm)
    got = sparse_decode_attention(*args9, **kw)
    want = plain.sparse_decode_attention_ref(*args9, **kw)
    err = check_close(torch, "sparse_decode_attention", got, want,
                      tol=TOL_STANDALONE)
    gate = gt9[:, :nb] > 0
    start, end = gt9[:, 2 * nb:], gt9[:, nb:2 * nb]
    live = ((end - start).clamp_min(0) * gate).sum().item()
    b_ms, b_by = bound_ms(nbytes(q9, qs9, idx9, gt9)
                          + live * (2 * dh + 8) + n_lanes * dh * 4,
                          int8_ops=2.0 * live * dh, f32_ops=2.0 * live * dh)
    # library yardstick: SDPA over the selected blocks, gathered and
    # dequantized beforehand, with the live-token mask
    sel = (idx9[..., None] * blk
           + torch.arange(blk, device=dev)).reshape(n_lanes, nb * blk)
    lane_ix = torch.arange(n_lanes, device=dev)[:, None]
    kg, vg = ((c[lane_ix, sel].float() * sc[lane_ix, sel])[:, None]
              for c, sc in ((k9, ks9), (v9, vs9)))
    tpos = torch.arange(blk, device=dev)
    live_mask = (gate[..., None] & (tpos >= start[..., None])
                 & (tpos < end[..., None]))
    lib9 = (lambda a, b_, c, m_: sdpa(a, b_, c, attn_mask=m_),
            ((q9.float() * qs9)[:, None], kg, vg,
             live_mask.reshape(n_lanes, 1, 1, nb * blk)))
    def kern9(*a):
        return sparse_decode_attention(*a, **kw)
    row = time_row(torch, kern9,
                   lambda *a: plain.sparse_decode_attention_ref(*a, **kw),
                   args9, 50, b_ms, b_by, lib=lib9)
    g_ms = graph_ms(torch, kern9, copies(torch, args9))
    shape = sparse_decode_launch_shape(n_lanes, 1, dh, blk, nb)
    log(f"  sparse_decode_attention lanes={n_lanes} g=1 K={nb} blocks of "
        f"{blk}, new_len={list(PER_HEAD_LEN)}: {fmt_row(row)} (library: "
        f"SDPA on the gathered dequantized blocks); in a CUDA graph "
        f"{g_ms:.4f} ms; {b_ms / row['ms']:.1%} of bound ({b_ms / g_ms:.1%}"
        f" in the graph); {fmt_decode_shape(shape)}; "
        f"{ptxas_summary(_build, 'int8_attention', 'sparse_decode_kernelILb1E')}"
        f" [{card}]")
    # the TPU kernel's masking: a gated block with an empty interval
    # before a live one weighs nothing; a lane whose gated blocks hold no
    # live token gives the mean of their V; a lane with no gate gives zero
    gt_m = gt9.clone()
    gt_m[0, :nb] = 1
    gt_m[0, nb], gt_m[0, 2 * nb] = 9, 9
    gt_m[1, :nb] = 1
    gt_m[1, nb:] = 5
    gt_m[2, :nb] = 0
    args_m = args9[:7] + (gt_m,)
    got = kern9(*args_m)
    err = max(err, check_close(
        torch, "sparse_decode_attention[masked intervals]", got,
        plain.sparse_decode_attention_ref(*args_m, **kw),
        tol=TOL_STANDALONE))
    if got[2].any() or not got[1].any():
        raise AssertionError("sparse_decode_attention: an ungated lane must "
                             "give zero and an all-masked lane the mean of V")
    log(f"  sparse_decode_attention: gated empty interval before a live "
        f"block, an all-masked lane (mean of V) and an ungated lane (zero) "
        f"agree with the plain version [{card}]")
    rows["sparse_decode_attention"] = dict(
        row, max_abs_err=err,
        shape=f"lanes={n_lanes} g=1 K={nb} block={blk} M={m_cap}")
    return rows


def per_head_decode(torch, ops, select_blocks, qi, qsc, lanes, new_len, *,
                    block, k_keep):
    """The paper's per-head predictive-sparse decode through the kernel
    API (the Fig. 8 path): one lop_screen over every (batch, kv-head)
    lane, select_blocks, one sparse_decode over every (batch, kv-head,
    group) lane. qi int8 [B, H, dh]; qsc f32 [B, H, 1]. → f32 [B, H, dh]."""
    b, h, dh = qi.shape
    hkv = lanes["k"].shape[1]
    g = h // hkv
    qg = qi.reshape(b, hkv, g, dh)
    scores = ops.lop_screen(qg, lanes["feat"])
    idx, gate_tokens = select_blocks(scores, new_len, block=block,
                                     k_keep=k_keep)
    out = ops.sparse_decode(
        qg[..., None, :], lanes["k"], lanes["v"],
        qsc.reshape(b, hkv, g, 1, 1), lanes["k_scale"][..., None],
        lanes["v_scale"][..., None], idx, gate_tokens, block=block,
        softmax_scale=dh ** -0.5)
    return out.reshape(b, h, dh)


def standalone_paths(torch, np, lanes, card) -> dict:
    """Parts 2 and 3: the TINT chain, one flash prefill and the per-head
    decode, each driven with the launch counts zeroed just before and
    read just after. → launches by kernel name."""
    from repro_torch.core.lop import kv_traffic_bytes
    from repro_torch.core.quantization import quantize
    from repro_torch.core.ternary import TernaryWeight
    from repro_torch.kernels import ops
    from repro_torch.serving.lop_select import select_blocks

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 15)
    launches = dict.fromkeys(STANDALONE, 0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def counted(label, fn, want):
        ops.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        check_counts(counts, label, want)
        for key in launches:
            launches[key] += counts[key]
        return out, counts

    # ---- the TINT chain == the fused projection, bitwise ----
    d = 3200
    cases = []
    for m in (4, 128):
        for label, n, per_col in (("qkv", 3 * d, True), ("o", d, False)):
            gamma = t((rng.uniform(0.01, 0.05, (1, n)) if per_col
                       else np.full((1, 1), 0.03)).astype(np.float32))
            cases.append((label, m, t(rng.standard_normal((m, d)).astype(
                np.float32)), TernaryWeight(t(rng.integers(
                    0, 256, (d // 4, n)).astype(np.uint8)), gamma, (d, n))))

    def chain():
        outs = []
        for _, _, x, tw in cases:
            xq = quantize(x)
            acc = ops.ternary_matmul(xq.values, tw)
            outs.append(acc.to(torch.float32) * xq.scale * tw.scale)
        return outs
    chained, _ = counted("TINT chain", chain, ("ternary_matmul",))
    for (label, m, x, tw), y in zip(cases, chained):
        fused = ops.qlinear_fused(x, tw.packed, tw.scale)
        torch.cuda.synchronize()
        if not torch.equal(y, fused):
            raise AssertionError(f"TINT chain [{label}, m={m}] != "
                                 "qlinear_fused")
    log(f"  TINT chain (absmax quantize -> ternary_matmul -> (acc*xs)*gamma)"
        f" == qlinear_fused bitwise for QKV (per-column gamma) and O (scalar"
        f" gamma) at m = 4 and 128; {launches['ternary_matmul']} "
        f"ternary_matmul launches")

    # ---- one head of flash prefill at 1536 tokens ----
    s_len, dh = 1536, lanes["k"].shape[-1]
    q8, k8, v8 = (t(rng.integers(-127, 128, (s_len, dh)).astype(np.int8))
                  for _ in range(3))
    scales = [t(rng.uniform(0.001, 0.02, (s_len, 1)).astype(np.float32))
              for _ in range(3)]
    out, _ = counted("flash prefill", lambda: ops.flash_prefill(
        q8, k8, v8, *scales, softmax_scale=dh ** -0.5, causal=True),
        ("int8_flash_prefill",))
    if out.shape != (s_len, dh) or not torch.isfinite(out).all():
        raise AssertionError(f"flash prefill: {tuple(out.shape)}, finite "
                             f"{bool(torch.isfinite(out).all())}")
    log(f"  flash_prefill (one head, s={s_len}, causal): finite [{s_len}, "
        f"{dh}] output")

    # ---- the per-head predictive-sparse decode vs the fused kernel ----
    b, hkv, m_cap, _ = lanes["k"].shape
    h, block, k_keep = hkv, 128, 2
    qi = t(rng.integers(-127, 128, (b, h, dh)).astype(np.int8))
    qsc = t(rng.uniform(0.001, 0.02, (b, h, 1)).astype(np.float32))
    new_len = torch.tensor(PER_HEAD_LEN, dtype=torch.int32, device=dev)

    def per_head(qi_, qsc_, k_, v_, ks_, vs_, f_, nl_):
        return per_head_decode(
            torch, ops, select_blocks, qi_, qsc_,
            dict(k=k_, v=v_, k_scale=ks_, v_scale=vs_, feat=f_), nl_,
            block=block, k_keep=k_keep)

    def fused(*a):
        return ops.decode_attention(*a, block=block, k_keep=k_keep)
    args = (qi, qsc, lanes["k"], lanes["v"], lanes["k_scale"],
            lanes["v_scale"], lanes["feat"], new_len)
    got, ph_counts = counted("per-head LOP decode", lambda: per_head(*args),
                             ("lop_scores_kernel", "sparse_decode_attention"))
    want, f_counts = counted("fused LOP decode", lambda: fused(*args),
                             ("fused_decode_attention",))
    err = check_close(torch, "per-head decode vs fused_decode_attention",
                      got, want, tol=TOL_STANDALONE)
    n_ph = sum(ph_counts.values())
    n_f = sum(f_counts.values())
    ph_ms = cuda_ms(torch, per_head, copies(torch, args), 20)
    f_ms = cuda_ms(torch, fused, copies(torch, args), 20)
    queries = b * h
    dense_b = queries * kv_traffic_bytes(m_cap, dh, 0, with_lop=False)
    lop_b = queries * kv_traffic_bytes(m_cap, dh, k_keep * block)
    scores_b = 2 * b * hkv * m_cap * 4       # int32 scores out and back in
    log(f"  per-head LOP decode (B={b}, H={h}, M={m_cap}, k_keep={k_keep}, "
        f"new_len={list(PER_HEAD_LEN)}): agrees with fused_decode_attention "
        f"(max |err| {err:.3g}, rtol=atol=1e-4); launches {n_ph} per-head "
        f"vs {n_f} fused; {ph_ms:.4f} ms per-head vs {f_ms:.4f} ms fused "
        f"(L2 cold) [{card}]")
    log(f"  modeled K/V bytes per decode step (kv_traffic_bytes, {queries} "
        f"head-queries): dense {dense_b}, per-head LOP {lop_b} (+{scores_b} "
        f"of int32 scores written and read back between its launches), "
        f"fused LOP {lop_b}")
    return launches


def standalone_phase(torch, np, engine, card) -> dict:
    """Phase 5. → rows of the four standalone kernels, with launches."""
    t0 = time.monotonic()
    lanes = cache_lanes(torch, np, engine)
    log(f"  K/V of layer {engine.cfg.n_layers - 1} from whole-prompt "
        f"prefills of {list(PER_HEAD_LEN)} tokens in "
        f"{time.monotonic() - t0:.1f} s [{card}]")
    rows = standalone_kernels(torch, np, lanes, card)
    launches = standalone_paths(torch, np, lanes, card)
    for name, n in launches.items():
        rows[name]["launches"] = n
    return rows


def _dev_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profiled(torch, fn):
    """Run ``fn`` under torch.profiler. → (device µs by kernel name, device
    µs in all, wall µs up to a synchronize)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for evt in prof.key_averages():
        # device-side events only (kernels, memcpys); the aten ops that
        # launched them would count the same time twice
        if "CUDA" not in str(getattr(evt, "device_type", "")):
            continue
        us = _dev_us(evt)
        if us > 0:
            by_name[evt.key] = by_name.get(evt.key, 0.0) + us
    return by_name, sum(by_name.values()), wall_us


def profile_steps(torch, sched, label: str, n_prof: int = 4):
    """Profile ``n_prof`` decode steps of ``sched`` (4 active lanes) and
    print the device's busy time and the top kernels a step. → (device µs,
    wall µs)."""
    by_name, dev_us, prof_wall_us = profiled(
        torch, lambda: [sched.step() for _ in range(n_prof)])
    if dev_us:
        log(f"  profiler, {n_prof} decode steps ({label}): device busy "
            f"{dev_us / 1e3:.2f} ms of {prof_wall_us / 1e3:.2f} ms wall "
            f"({100 * dev_us / prof_wall_us:.1f}%, profiler on); top device "
            f"time per step:")
        for key, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
            log(f"    {us / n_prof / 1e3:8.3f} ms  {key[:90]}")
    else:
        log("  profiler: no device time recorded (busy share not measured)")
    return dev_us, prof_wall_us


def steady_phase(torch, np, engine, reqs, card) -> dict:
    """Clean timings outside the serve run: a decode step over 4 active
    lanes with no prefill in flight, one 128-token prefill chunk at the end
    of a 1536-token prompt, a whole-prompt prefill, and a profiler
    breakdown of decode steps and of one chunk (device time by kernel,
    busy share)."""
    arms = decode_arms(torch, np, engine, reqs, "LOP greedy", card)
    prof = profile_arms(torch, arms, "LOP greedy", card)
    decode_ms, eager_ms = arms["ms"], arms["eager_ms"]
    del arms                      # their pools would count in later peaks

    # one 128-token chunk at positions [1408, 1536) of a spare lane
    pool = engine.init_pool(1)
    chunk = np.asarray(reqs[0].prompt[:128], np.int32)[None]
    chunk_s = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, pool = engine.prefill_chunk(pool, 0, chunk, 1408, 1536, True)
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
    chunk_ms = float(np.median(chunk_s[1:]) * 1e3)
    by_name, chunk_dev_us, chunk_wall_us = profiled(
        torch, lambda: engine.prefill_chunk(pool, 0, chunk, 1408, 1536, True))
    if chunk_dev_us:
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        log(f"  profiler, one prefill chunk: device busy "
            f"{chunk_dev_us / 1e3:.2f} ms of {chunk_wall_us / 1e3:.2f} ms wall"
            f" ({100 * chunk_dev_us / chunk_wall_us:.1f}%, profiler on); top: "
            + "; ".join(f"{us / 1e3:.3f} ms {key[:60]}" for key, us in top))
    prompt = reqs[0].prompt
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.prefill(prompt[None])
    torch.cuda.synchronize()
    whole_ms = (time.perf_counter() - t0) * 1e3
    log(f"  prefill chunk (128 tokens at 1408, 26 layers): {chunk_ms:.2f} ms;"
        f" whole-prompt prefill of {len(prompt)} tokens: {whole_ms:.1f} ms "
        f"[{card}]")
    del pool, logits
    return dict(decode_step_ms_p50=decode_ms, prefill_chunk_ms=chunk_ms,
                eager_decode_step_ms_p50=eager_ms, whole_prefill_ms=whole_ms,
                device_ms=prof["graph"][0], eager_device_ms=prof["eager"][0],
                profile_device_busy=prof["graph"][1])


# ---------------------------------------------------------------------------

def main() -> int:
    t_start = time.monotonic()
    try:
        import torch
    except ImportError:
        return fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: no CUDA card")
    if not (SRC / "repro_torch" / "csrc").is_dir():
        return fail(f"{SRC / 'repro_torch'} is missing: run from a checkout "
                    "of the repository")
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. device ----
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[device] {name} x{count}; nvidia-smi: {smi}; torch "
        f"{torch.__version__} CUDA {torch.version.cuda}")

    # ---- 2. build ----
    t0 = time.monotonic()
    libs = _build.build_all()
    for src in _build.SOURCES:
        _build.load(src)
    log(f"[build] {len(libs)} libraries in {time.monotonic() - t0:.1f} s")
    for src in _build.SOURCES:
        for line in _build.ptxas_report(src).splitlines():
            log(f"  {src}: {line.strip()}")

    # ---- 3. kernels ----
    log(f"[kernels] full-width shapes, held against the plain versions "
        f"(rtol=atol={TOL['rtol']}; projections bitwise) [{smi}]")
    rows = kernel_phase(torch, np)

    # ---- 4. serve ----
    log(f"[serve] bitnet-3b full width, {N_SLOTS} slots, {N_REQUESTS} "
        f"requests, gen {GEN} [{smi}]")
    engine, reqs, serve = serve_phase(torch, np, smi)

    # ---- 4b. no-LOP serve ----
    log(f"[serve no-LOP] the same {N_REQUESTS} requests on a use_lop=False "
        f"engine sharing the weights [{smi}]")
    nolop = nolop_phase(torch, np, engine, reqs, smi)
    log(f"  decode step (B={N_SLOTS}, no prefill in flight), CUDA graph "
        f"(eager): LOP {serve['decode_step_ms_p50']:.2f} "
        f"({serve['eager_decode_step_ms_p50']:.2f}) ms, no-LOP "
        f"{nolop['decode_step_ms_p50']:.2f} "
        f"({nolop['eager_decode_step_ms_p50']:.2f}) ms [{smi}]")

    # ---- 4c. sampled serve and faults ----
    log(f"[serve sampled + faults] [{smi}]")
    sampled = sampled_fault_phase(torch, np, engine, nolop["dense"], reqs, smi)
    log(f"  decode step (B={N_SLOTS}, no prefill in flight), LOP, CUDA "
        f"graph (eager): greedy {serve['decode_step_ms_p50']:.2f} "
        f"({serve['eager_decode_step_ms_p50']:.2f}) ms, sampled "
        f"{sampled['sampled_decode_step_ms_p50']:.2f} "
        f"({sampled['sampled_eager_decode_step_ms_p50']:.2f}) ms [{smi}]")
    launches = dict(serve["counts"])
    launches[DENSE] = nolop["counts"][DENSE] + sampled["dense_launches"]

    # ---- 5. standalone kernels and the per-head LOP decode ----
    log(f"[standalone kernels + per-head LOP decode] full width (d 3200, "
        f"32 heads of 100, ffn 8640, capacity 1664, lop_block 128, k_keep "
        f"2); integers bitwise, f32 at rtol=atol={TOL_STANDALONE['rtol']} "
        f"[{smi}]")
    standalone = standalone_phase(torch, np, engine, smi)
    for kname, row in standalone.items():
        launches[kname] = row["launches"]
    rows.update(standalone)

    sources = {"fused_qlinear": ("qlinear.cu", "src/repro/kernels/qlinear.py:224"),
               "fused_ffn": ("qlinear.cu", "src/repro/kernels/qlinear.py:368"),
               "fused_prefill_attention": (
                   "prefill_attention.cu",
                   "src/repro/kernels/prefill_attention.py:217"),
               "fused_decode_attention": (
                   "decode_attention.cu",
                   "src/repro/kernels/decode_attention.py:422"),
               DENSE: ("decode_attention.cu",
                       "src/repro/kernels/decode_attention.py:380"),
               "ternary_matmul": (
                   "ternary_matmul.cu",
                   "src/repro/kernels/ternary_matmul.py:77"),
               "lop_scores_kernel": (
                   "lop_scores.cu", "src/repro/kernels/lop_scores.py:71"),
               "int8_flash_prefill": (
                   "int8_attention.cu",
                   "src/repro/kernels/int8_attention.py:122"),
               "sparse_decode_attention": (
                   "int8_attention.cu",
                   "src/repro/kernels/int8_attention.py:237")}
    kernels = []
    for kname, row in rows.items():
        src, replaces = sources[kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}", "replaces": replaces,
            "launches": launches[kname],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"]})
    log(f"[done] {time.monotonic() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
