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
              the same function, that call's time;
  4. serve    full-width bitnet-3b with seeded random weights: 8 requests
              of 128–1536 prompt tokens (numpy default_rng(0)), 32 new
              tokens each, through the continuous-batching Scheduler on 4
              slots; launch counts are zeroed just before and read just
              after, and must all be > 0; the Scheduler's tokens must equal
              lockstep_generate's for 2 requests, and chunked prefill must
              equal whole-prompt prefill bitwise for one prompt; then
              clean timings: a decode step over 4 active lanes with no
              prefill in flight, one prefill chunk, a whole-prompt prefill,
              and a torch.profiler breakdown of decode steps.

The line before the last two is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------------------
# phase 3: kernels at the main path's shapes
# ---------------------------------------------------------------------------

def check_close(torch, name, got, want, bitwise=False) -> float:
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if bitwise:
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: not bitwise the plain version "
                                 f"(max |err| {err})")
    else:
        torch.testing.assert_close(got, want, **TOL, msg=lambda m: f"{name}: {m}")
    return err


def kernel_phase(torch, np) -> dict:
    from repro_torch.core.lop import lop_features, pack_features
    from repro_torch.kernels import ref as plain
    from repro_torch.kernels.decode_attention import fused_decode_attention
    from repro_torch.kernels.prefill_attention import fused_prefill_attention
    from repro_torch.kernels.qlinear import fused_ffn, fused_qlinear

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    d, f, h, dh, m_cap, blk = 3200, 8640, 32, 100, 1664, 128
    rows = {}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # ---- #1 fused_qlinear: QKV and O at decode (m = 4) and chunk (128) ----
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
        ms = cuda_ms(torch, fused_qlinear, copies(torch, args), 50)
        p_ms = cuda_ms(torch, lambda a, b, c: plain.qlinear_ref(a, b, c[None]),
                       [args], 3)
        b_ms, b_by = bound_ms(nbytes(x, packed, gamma) + m * n * 4,
                              int8_ops=2.0 * m * k * n)
        log(f"  fused_qlinear {label} m={m} k={k} n={n}: {ms:.4f} ms "
            f"(plain {p_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by}) "
            f"bitwise={True}")
        if timed is None:
            timed = dict(ms=ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                         shape=f"{label} m={m} k={k} n={n}")
    rows["fused_qlinear"] = dict(timed, max_abs_err=err, library_ms=None)

    # ---- #2 fused_ffn at decode (m = 4) and chunk (128) ----
    err, timed = 0.0, None
    for m in (4, 128):
        x = t(rng.standard_normal((m, d)).astype(np.float32))
        gu = t(rng.integers(0, 256, (d // 4, 2 * f)).astype(np.uint8))
        gs = t(rng.uniform(0.01, 0.05, (2 * f,)).astype(np.float32))
        down = t(rng.integers(0, 256, (f // 4, d)).astype(np.uint8))
        ds = t(np.full((d,), 0.02, np.float32))
        args = (x, gu, gs, down, ds)

        def kern(*a):
            return fused_ffn(*a, gated=True, act="silu")

        def ref(x_, gu_, gs_, down_, ds_):
            return plain.ffn_fused_ref(x_, gu_, gs_[None], down_, ds_[None],
                                       gated=True, act="silu")
        got, want = kern(*args), ref(*args)
        err = max(err, check_close(torch, f"fused_ffn[m={m}]", got, want))
        ms = cuda_ms(torch, kern, copies(torch, args), 30)
        p_ms = cuda_ms(torch, ref, [args], 3)
        b_ms, b_by = bound_ms(nbytes(*args) + m * d * 4,
                              int8_ops=2.0 * m * d * 2 * f + 2.0 * m * f * d)
        log(f"  fused_ffn m={m} d={d} f={f}: {ms:.4f} ms (plain {p_ms:.3f} "
            f"ms, bound {b_ms:.4f} ms by {b_by}) bitwise="
            f"{bool(torch.equal(got, want))}")
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
    for label, r, q_off in (("chunk", c, s_total - c), ("whole", s_total, 0)):
        qi = t(rng.integers(-127, 128, (h, r, dh)).astype(np.int8))
        qsc = t((rng.random((h, r)) * 0.02 + 0.001).astype(np.float32))
        kv_len = torch.tensor([q_off + r], dtype=torch.int32, device=dev)
        args = (qi, qsc, k_c, v_c, ks, vs, kv_len, q_off)
        scale = dh ** -0.5

        def kern(*a):
            return fused_prefill_attention(*a, hkv=h, chunk=r, causal=True,
                                           window=0, softmax_scale=scale)

        def ref(qi_, qsc_, k_, v_, ks_, vs_, kvl_, qo_):
            return plain.prefill_attention_ref(
                qi_[None], qsc_[None], k_[None], v_[None], ks_[None],
                vs_[None], kvl_, qo_, causal=True, softmax_scale=scale)[0]
        got, want = kern(*args), ref(*args)
        err = max(err, check_close(torch, f"fused_prefill_attention[{label}]",
                                   got, want))
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
        log(f"  fused_prefill_attention {label} R={r} q_off={q_off} M={m_cap}:"
            f" {ms:.4f} ms (plain {p_ms:.3f} ms, SDPA {lib_ms:.4f} ms, bound"
            f" {b_ms:.4f} ms by {b_by})")
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
    ms = cuda_ms(torch, kern, copies(torch, args), 50)
    p_ms = cuda_ms(torch, ref, [args], 3)
    nl = new_len.tolist()
    live_tok = sum(min(n_, k_keep * blk) for n_ in nl if n_)  # ≤ K blocks
    sel_blocks = sum(min(k_keep, -(-n_ // blk)) for n_ in nl if n_)
    b_ms, b_by = bound_ms(
        nbytes(qi, qsc, new_len) + h * sum(nl) * (dh // 2)
        + h * sel_blocks * blk * (2 * dh + 8) + bh * dh * 4,
        int8_ops=2.0 * h * (sum(nl) + live_tok) * dh,
        f32_ops=2.0 * h * live_tok * dh)
    log(f"  fused_decode_attention B={b} M={m_cap} k_keep={k_keep}: "
        f"{ms:.4f} ms (plain {p_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by})")
    rows["fused_decode_attention"] = dict(
        ms=ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        max_abs_err=err, shape=f"B={b} H=32 M={m_cap} k_keep={k_keep}")
    return rows


# ---------------------------------------------------------------------------
# phase 4: serve full-width bitnet-3b
# ---------------------------------------------------------------------------

def serve_phase(torch, np, card: str) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import make_requests
    from repro_torch.serving.api import GenerateRequest, PooledEngine
    from repro_torch.serving.scheduler import Scheduler, lockstep_generate

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

    sched = Scheduler(engine, n_slots=N_SLOTS)
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
    log(f"  launch counts on the serve path: {counts}")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the serve path: "
                             f"{missing}")
    if sorted(results) != list(range(N_REQUESTS)):
        raise AssertionError(f"finished rids {sorted(results)}")
    for r in results.values():
        if len(r.tokens) != GEN or not all(0 <= x < cfg.vocab_padded
                                           for x in r.tokens):
            raise AssertionError(f"rid {r.rid}: bad tokens {r.tokens}")
    n_tok = sum(len(r.tokens) for r in results.values())
    ttft = [r.ttft for r in results.values()]
    step_ms = np.percentile(sched.decode_seconds, 50) * 1e3
    log(f"  served {N_REQUESTS} requests, {n_tok} tokens in {wall:.3f} s: "
        f"{n_tok / wall:.2f} tok/s, TTFT p50 {np.percentile(ttft, 50) * 1e3:.1f}"
        f" ms, serve-cycle decode p50 {step_ms:.2f} ms over "
        f"{sched.decode_steps} steps (waits on the cycle's prefill chunk), "
        f"max_memory_allocated {peak / 2**30:.2f} GiB [{card}]")

    # scheduler vs lockstep, token for token, on two requests
    for rid in (0, 1):
        ref = lockstep_generate(engine, reqs[rid].prompt, GEN)
        if ref != results[rid].tokens:
            raise AssertionError(f"rid {rid}: scheduler {results[rid].tokens}"
                                 f" != lockstep {ref}")
    log("  scheduler tokens == lockstep tokens for rids 0, 1")

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
    steady = steady_phase(torch, np, engine, reqs, card)
    return dict(counts=counts, tokens_per_s=n_tok / wall,
                ttft_p50_ms=float(np.percentile(ttft, 50) * 1e3),
                serve_cycle_decode_ms_p50=float(step_ms), peak_bytes=peak,
                **steady)


def _dev_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def steady_phase(torch, np, engine, reqs, card) -> dict:
    """Clean timings outside the serve run: a decode step over 4 active
    lanes with no prefill in flight, one 128-token prefill chunk at the end
    of a 1536-token prompt, a whole-prompt prefill, and a profiler
    breakdown of decode steps (device time by kernel, busy share)."""
    from dataclasses import replace

    from repro_torch.serving.scheduler import Scheduler

    sched = Scheduler(engine, n_slots=N_SLOTS)
    for r in reqs[:N_SLOTS]:
        sched.submit(replace(r, max_new_tokens=96, arrival=None))
    sched.admit()
    while sched.n_prefilling:
        sched.step()
    if sched.n_active != N_SLOTS:
        raise AssertionError(f"{sched.n_active} lanes active, want {N_SLOTS}")
    step_s = []
    for _ in range(12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sched.step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    decode_ms = float(np.median(step_s[2:]) * 1e3)

    from torch.profiler import ProfilerActivity, profile
    n_prof = 4
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            sched.step()
        torch.cuda.synchronize()
        prof_wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for evt in prof.key_averages():
        # device-side events only (kernels, memcpys); the aten ops that
        # launched them would count the same time twice
        if "CUDA" not in str(getattr(evt, "device_type", "")):
            continue
        us = _dev_us(evt)
        if us > 0:
            by_name[evt.key] = by_name.get(evt.key, 0.0) + us
    dev_us = sum(by_name.values())
    log(f"  decode step (B={N_SLOTS}, no prefill in flight): p50 "
        f"{decode_ms:.2f} ms over {len(step_s) - 2} steps [{card}]")
    if dev_us:
        log(f"  profiler, {n_prof} decode steps: device busy "
            f"{dev_us / 1e3:.2f} ms of {prof_wall_us / 1e3:.2f} ms wall "
            f"({100 * dev_us / prof_wall_us:.1f}%, profiler on); top device "
            f"time per step:")
        for key, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
            log(f"    {us / n_prof / 1e3:8.3f} ms  {key[:90]}")
    else:
        log("  profiler: no device time recorded (busy share not measured)")

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
                whole_prefill_ms=whole_ms,
                profile_device_busy=dev_us / prof_wall_us if dev_us else None)


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
    serve = serve_phase(torch, np, smi)

    sources = {"fused_qlinear": ("qlinear.cu", "src/repro/kernels/qlinear.py:224"),
               "fused_ffn": ("qlinear.cu", "src/repro/kernels/qlinear.py:368"),
               "fused_prefill_attention": (
                   "prefill_attention.cu",
                   "src/repro/kernels/prefill_attention.py:217"),
               "fused_decode_attention": (
                   "decode_attention.cu",
                   "src/repro/kernels/decode_attention.py:422")}
    kernels = []
    for kname, row in rows.items():
        src, replaces = sources[kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}", "replaces": replaces,
            "launches": serve["counts"][kname],
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
