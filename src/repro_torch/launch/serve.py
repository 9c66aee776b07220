"""Continuous-batching serving entry point of the port.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch {bitnet-3b,granite-moe-1b-a400m,mixtral-8x22b,stablelm-1.6b,
                qwen1.5-32b,mistral-nemo-12b,whisper-small,rwkv6-1.6b,
                jamba-1.5-large-398b,llava-next-34b} \\
        --slots 4 --requests 8 --gen 32 [--reduced] [--device cpu] \\
        [--no-lop] [--temperature T --top-k K --top-p P --sample-seed S] \\
        [--no-chunked] [--chunk-tokens C] [--arrival-period SECONDS] \\
        [--shared-prefix-tokens N --prefix-reuse-frac F] [--no-prefix-cache] \\
        [--spec-decode --gamma G --draft-layers L --draft-k K] \\
        [--max-queue N] [--deadline-ms MS] [--stream] [--verify]

Builds a seeded model on the device (the CUDA card unless ``--device cpu``),
drawn and quantized one layer at a time, synthesizes requests with prompt lengths drawn from
``numpy.random.default_rng(seed)``, serves them through the
:class:`repro_torch.serving.scheduler.Scheduler` (chunked prefill
interleaved with decode; whole prompts at their exact length for a moe,
encdec, ssm (rwkv6) or hybrid (jamba, served ``--reduced``: its full
width does not fit one card) model, which never chunks; an encdec
request carries ``4 × plen``
seeded encoder frames, and a vlm (llava) request ``n_img_tokens`` seeded
patch rows before its text, which the cache's ``max_len`` makes room
for, as the reference's CLI draws them) and reports
tokens/s, latency, TTFT and ITL percentiles (through :func:`repro_torch.serving.metrics.summarize`, under
the reference's ``launch/serve.py`` keys), the time of a serve cycle's
decode call and, last, the modeled K/V traffic per head and query, dense against LOP. The
scheduler publishes onto a private registry per run (``out["metrics"]``):
the series the HTTP server (``repro_torch.launch.server``) exports on
``/metrics``. ``--no-lop`` decodes with dense attention
(the LOP ablation arm); the sampling flags give every request the same
policy, request ``rid`` sampling under seed ``sample_seed + rid``.
``--shared-prefix-tokens N --prefix-reuse-frac F`` prepends one common
N-token prefix (a shared system prompt) to the first F of the requests;
the scheduler's prefix cache (on unless ``--no-prefix-cache``) serves its
blocks from interned pages, and the run prints hits, prefill tokens
computed against served, and TTFT of hits against misses.
``--spec-decode`` drafts ``--gamma`` tokens a round with the first
``--draft-layers`` layers and ``--draft-k`` LOP blocks, and verifies the
γ+1 positions in one chunk; the run prints rounds, acceptance and
full-model launches per token.
``--no-chunked`` prefills every prompt whole at its exact length, run to
completion before the next decode step (the reference's run-to-completion
regime; the prefix store and speculation need chunks and are then off).
``--chunk-tokens`` sets the prefill chunk width (default the arch's
``lop_block``); ``--arrival-period`` spaces the arrivals: request ``rid``
arrives ``rid × period`` seconds after the start, so lanes drain and
refill mid-run as on a live server (0: all arrive at the start).
``--max-queue`` sheds submits past that queue depth and ``--deadline-ms``
gives every request that latency budget. ``--verify`` replays every
request that finished naturally (eos, stop, length; no fault recovery
touched it) alone through :func:`lockstep_generate` and checks token-exact
agreement.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import replace

import numpy as np
import torch

from repro_torch.configs import resolve_config
from repro_torch.core.lop import kv_traffic_bytes
from repro_torch.serving.api import (GenerateRequest, PooledEngine,
                                     SamplingParams, StepResult)
from repro_torch.serving.metrics import MetricsRegistry, percentile, summarize
from repro_torch.serving.scheduler import Scheduler, lockstep_generate


def make_requests(cfg, *, n_requests: int, min_prompt: int, max_prompt: int,
                  gen: int, seed: int = 0,
                  sampling: SamplingParams | None = None,
                  shared_prefix_tokens: int = 0,
                  prefix_reuse_frac: float = 1.0,
                  deadline_ms: float | None = None, on_token=None) -> list:
    """Prompts of ``[min_prompt, max_prompt]`` random tokens, FIFO order.
    With ``sampling`` given, request ``rid`` samples under seed
    ``sampling.seed + rid``. ``shared_prefix_tokens > 0`` prepends ONE
    common prefix of that many tokens to the first
    ``round(prefix_reuse_frac * n_requests)`` prompts. An encdec request
    carries ``4 × plen`` encoder frames of 0.02·N(0, 1), a vlm request
    ``n_img_tokens`` patch rows of 0.02·N(0, 1) (the reference's draws, in
    its order)."""
    if not 0 < min_prompt <= max_prompt:
        raise ValueError(f"need 0 < min_prompt <= max_prompt, got "
                         f"{min_prompt}..{max_prompt}")
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, cfg.vocab,
                          (shared_prefix_tokens,)).astype(np.int32)
    n_sharers = (round(prefix_reuse_frac * n_requests)
                 if shared_prefix_tokens else 0)
    reqs = []
    for rid in range(n_requests):
        plen = int(rng.integers(min_prompt, max_prompt + 1))
        prompt = rng.integers(0, cfg.vocab, (plen,)).astype(np.int32)
        if rid < n_sharers:
            prompt = np.concatenate([shared, prompt])
        frames = patches = None
        if cfg.family == "encdec":
            frames = (rng.standard_normal((4 * plen, cfg.d_model))
                      .astype(np.float32) * 0.02)
        if cfg.family == "vlm":
            patches = (rng.standard_normal((cfg.n_img_tokens, cfg.d_model))
                       .astype(np.float32) * 0.02)
        sp = SamplingParams() if sampling is None else \
            replace(sampling, seed=sampling.seed + rid)
        reqs.append(GenerateRequest(rid=rid, prompt=prompt,
                                    max_new_tokens=gen, sampling=sp,
                                    deadline_ms=deadline_ms,
                                    on_token=on_token, frames=frames,
                                    patches=patches))
    return reqs


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_loop(engine: PooledEngine, reqs: list, *, n_slots: int,
               max_queue: int | None = None, verify: bool = False,
               chunked: bool = True, prefix_cache: bool = True,
               spec_decode: bool = False, gamma: int = 4,
               arrival_period: float = 0.0) -> dict:
    """Serve ``reqs`` → stats dict, its counters read back off the run's
    own registry (``"metrics"``). Request ``rid`` arrives ``rid ×
    arrival_period`` seconds after the start (all at once for 0); one not
    yet arrived stays out of the queue, and the loop sleeps to the next
    arrival when no lane has work."""
    registry = MetricsRegistry()
    sched = Scheduler(engine, n_slots=n_slots, max_queue=max_queue,
                      chunked=chunked, prefix_cache=prefix_cache,
                      spec_decode=spec_decode, gamma=gamma, metrics=registry)
    _sync(engine.device)
    t0 = time.monotonic()
    pending = list(reqs)
    while pending or sched.has_work():
        now = time.monotonic() - t0
        while pending and now >= pending[0].rid * arrival_period:
            sched.submit(replace(pending.pop(0), arrival=time.monotonic()))
            now = time.monotonic() - t0
        sched.admit()
        if sched.n_active or sched.n_prefilling:
            sched.step()
        elif pending:
            time.sleep(max(0.0, pending[0].rid * arrival_period - now))
    results = sorted(sched.results, key=lambda r: r.rid)
    _sync(engine.device)
    wall = time.monotonic() - t0
    total = sum(len(r.tokens) for r in results)
    lat = [r.latency for r in results]
    ttft = [r.ttft for r in results]
    ttft_hit = [r.ttft for r in results if r.cached_len] or [np.nan]
    ttft_miss = [r.ttft for r in results if not r.cached_len] or [np.nan]
    itl = [g for r in results for g in r.itl] or [0.0]
    out = {
        "results": results,
        "tokens": {r.rid: list(r.tokens) for r in results},
        "wall_s": wall,
        "tokens_per_s": total / max(wall, 1e-9),
        "metrics": registry,
        **summarize(lat, (50, 90, 99), prefix="latency_"),
        **summarize(ttft, (50, 90, 99), prefix="ttft_"),
        **summarize(itl, (50, 99), prefix="itl_"),
        **summarize(ttft_hit, (50, 99), prefix="ttft_hit_"),
        **summarize(ttft_miss, (50, 99), prefix="ttft_miss_"),
        "serve_cycle_decode_ms_p50": percentile(sched.decode_seconds,
                                                50) * 1e3,
        "decode_launches": sched.decode_launches,
        "chunked": sched.chunked,
        "chunk_tokens": sched.chunk_tokens,
        "arrival_period": arrival_period,
        "full_prefills": len(sched.full_prefill_seconds),
        "full_prefill_ms_p50": percentile(sched.full_prefill_seconds,
                                          50) * 1e3,
        "full_prefill_stalls": sched.full_prefill_stalls,
        "prefix_cache": sched.prefix_store is not None,
        "prefix_hits": sched.prefix_hits,
        "prefix_hit_tokens": sched.prefix_hit_tokens,
        "prefill_tokens_computed": sched.prefill_tokens_computed,
        "prefill_tokens_served": sched.prefill_tokens_served,
        "spec_decode": sched.spec,
        "spec_rounds": sched.spec_rounds,
        "spec_drafted": sched.spec_drafted,
        "spec_accepted": sched.spec_accepted,
        "spec_emitted": sched.spec_emitted,
        "spec_verify_launches": sched.spec_verify_launches,
        "draft_launches": sched.draft_launches,
        "spec_accept_rate": sched.spec_accepted / max(1, sched.spec_drafted),
        "spec_tokens_per_verify": (sched.spec_emitted
                                   / max(1, sched.spec_verify_launches)),
        # full-model launches (plain decode + verify) a generated token:
        # below 1 is what speculation buys
        "full_launches_per_token": ((sched.decode_launches
                                     + sched.spec_verify_launches)
                                    / max(1, total)),
        "prefix_lookup_failures": sched.prefix_lookup_failures,
        "checksum_failures": (sched.prefix_store.checksum_failures
                              if sched.prefix_store is not None else 0),
        "spec_watchdog_trips": sched.spec_watchdog_trips,
        "shed_count": int(registry.value("repro_requests_shed_total")),
        "deadline_count": int(registry.value("repro_deadline_expired_total")),
        "fault_events": int(registry.value("repro_fault_events_total")),
        "fault_recoveries": int(
            registry.value("repro_fault_recoveries_total")),
        "fault_finishes": int(registry.value("repro_fault_finishes_total")),
    }
    if verify:
        # only naturally finished requests have a lockstep counterpart
        reason = {r.rid: r.finish_reason for r in results}
        mismatched, skipped = [], []
        for req in reqs:
            if reason.get(req.rid) not in ("eos", "stop", "length") \
                    or req.rid in sched.fault_rids:
                skipped.append(req.rid)
                continue
            ref = lockstep_generate(engine, req.prompt, req.max_new_tokens,
                                    eos_id=req.eos_id, sampling=req.sampling,
                                    stop=req.stop, frames=req.frames,
                                    patches=req.patches)
            if out["tokens"][req.rid] != ref:
                mismatched.append(req.rid)
        out["verified"] = not mismatched
        out["mismatched_rids"] = mismatched
        out["verify_skipped_rids"] = skipped
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="bitnet-3b",
                    help="bitnet-3b, granite-moe-1b-a400m, mixtral-8x22b, "
                         "stablelm-1.6b, qwen1.5-32b, mistral-nemo-12b, "
                         "whisper-small, rwkv6-1.6b, jamba-1.5-large-398b "
                         "(with --reduced) or llava-next-34b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--min-prompt", type=int, default=8)
    ap.add_argument("--max-prompt", type=int, default=48)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--no-lop", action="store_true",
                    help="dense decode attention (the LOP ablation arm)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="per-request sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="per-request top-k filter (0 = off)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="per-request nucleus filter (1 = off)")
    ap.add_argument("--sample-seed", type=int, default=0,
                    help="base PRNG seed; request rid samples under "
                         "seed+rid")
    ap.add_argument("--no-chunked", action="store_true",
                    help="run-to-completion prefill (disable chunked "
                         "prefill/decode interleaving)")
    ap.add_argument("--chunk-tokens", type=int, default=None,
                    help="prefill chunk size (default: the arch's lop_block)")
    ap.add_argument("--arrival-period", type=float, default=0.0,
                    help="seconds between request arrivals (staggered)")
    ap.add_argument("--shared-prefix-tokens", type=int, default=0,
                    help="length of ONE common prompt prefix (a shared "
                         "system prompt) prepended to sharing requests")
    ap.add_argument("--prefix-reuse-frac", type=float, default=1.0,
                    help="fraction of requests sharing the common prefix")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="turn the scheduler's prefix store off (every "
                         "prompt prefills cold)")
    ap.add_argument("--spec-decode", action="store_true",
                    help="self-speculative decoding: draft with a layer "
                         "prefix and a pinched LOP budget, verify γ+1 "
                         "positions in one chunk, accept the agreeing "
                         "prefix")
    ap.add_argument("--gamma", type=int, default=4,
                    help="speculative draft length a round")
    ap.add_argument("--draft-layers", type=int, default=None,
                    help="decoder layers the draft runs (default: "
                         "n_layers // 2)")
    ap.add_argument("--draft-k", type=int, default=None,
                    help="LOP blocks the draft attention keeps (default 1)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="admission bound: submits past this queue depth "
                         "are shed (reason \"shed\")")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request latency budget from arrival; expired "
                         "requests retire with reason \"deadline\"")
    ap.add_argument("--stream", action="store_true",
                    help="print tokens as lanes emit them")
    ap.add_argument("--verify", action="store_true",
                    help="replay each naturally finished request alone "
                         "(lockstep, same SamplingParams) and check "
                         "token-exact agreement")
    args = ap.parse_args(argv)

    cfg = resolve_config(args.arch, args.reduced)
    max_len = args.max_prompt + args.gen + args.shared_prefix_tokens
    if cfg.family == "vlm":
        max_len += cfg.n_img_tokens       # the image prefix shares the cache
    engine = PooledEngine.from_seed(cfg, seed=args.seed, max_len=max_len,
                                    device=args.device,
                                    use_lop=not args.no_lop,
                                    chunk_tokens=args.chunk_tokens,
                                    draft_layers=args.draft_layers,
                                    draft_k=args.draft_k)
    sampling = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                              top_p=args.top_p, seed=args.sample_seed)
    on_token = None
    if args.stream:
        def on_token(sr: StepResult):
            flag = f" <{sr.finish_reason}>" if sr.finished else ""
            print(f"  [rid {sr.rid}] #{sr.index} -> {sr.token}{flag}")

    reqs = make_requests(cfg, n_requests=args.requests,
                         min_prompt=args.min_prompt,
                         max_prompt=args.max_prompt, gen=args.gen,
                         seed=args.seed + 1,
                         sampling=None if sampling.greedy else sampling,
                         shared_prefix_tokens=args.shared_prefix_tokens,
                         prefix_reuse_frac=args.prefix_reuse_frac,
                         deadline_ms=args.deadline_ms, on_token=on_token)
    regime = ("run-to-completion prefill" if args.no_chunked
              else f"chunk {engine.chunk_tokens} tokens")
    mode = "greedy" if sampling.greedy else (
        f"T={sampling.temperature} top_k={sampling.top_k} "
        f"top_p={sampling.top_p}")
    print(f"serving {cfg.name} on {engine.device}: {args.slots} slots, "
          f"{args.requests} requests (prompts {args.min_prompt}-"
          f"{args.max_prompt}, gen {args.gen}), lop="
          f"{'off' if args.no_lop else 'on'}, sampling {mode}, {regime}, "
          f"arrivals every {args.arrival_period} s")
    out = serve_loop(engine, reqs, n_slots=args.slots,
                     max_queue=args.max_queue, verify=args.verify,
                     chunked=not args.no_chunked,
                     prefix_cache=not args.no_prefix_cache,
                     spec_decode=args.spec_decode, gamma=args.gamma,
                     arrival_period=args.arrival_period)
    for r in out["results"]:
        print(f"rid {r.rid:>3} prompt {r.prompt_len:>5} cached "
              f"{r.cached_len:>5} tokens {len(r.tokens):>4} ttft "
              f"{r.ttft * 1e3:9.1f} ms latency {r.latency * 1e3:9.1f} ms  "
              f"{r.finish_reason}")
    print(f"wall {out['wall_s']:.3f} s, {out['tokens_per_s']:.1f} tok/s; "
          f"latency p50/p90/p99: {out['latency_p50'] * 1e3:.1f} / "
          f"{out['latency_p90'] * 1e3:.1f} / {out['latency_p99'] * 1e3:.1f} "
          f"ms; ttft p50/p90: {out['ttft_p50'] * 1e3:.1f} / "
          f"{out['ttft_p90'] * 1e3:.1f} ms; itl p50/p99: "
          f"{out['itl_p50'] * 1e3:.1f} / {out['itl_p99'] * 1e3:.1f} ms; "
          f"serve-cycle decode p50 {out['serve_cycle_decode_ms_p50']:.2f} ms "
          f"(waits on the cycle's prefill chunk)")
    if not out["chunked"]:
        print(f"full-prompt prefills (exact length, run to completion): "
              f"{out['full_prefills']}, p50 {out['full_prefill_ms_p50']:.2f}"
              f" ms, {out['full_prefill_stalls']} stalled decoding lanes")
    if out["spec_decode"]:
        print(f"speculative decode: {out['spec_rounds']} rounds, accept "
              f"rate {out['spec_accept_rate']:.2f} ({out['spec_accepted']}/"
              f"{out['spec_drafted']} drafts), "
              f"{out['spec_tokens_per_verify']:.2f} tokens/verify launch, "
              f"{out['full_launches_per_token']:.2f} full-model launches "
              f"per token ({out['decode_launches']} decode + "
              f"{out['spec_verify_launches']} verify; "
              f"{out['draft_launches']} draft steps of "
              f"{engine.draft_layers} layers, draft_k {engine.draft_k})")
    if out["prefix_cache"]:
        print(f"prefix cache: {out['prefix_hits']} hits "
              f"({out['prefix_hit_tokens']} tokens served from interned "
              f"pages), prefill tokens computed/served: "
              f"{out['prefill_tokens_computed']}/"
              f"{out['prefill_tokens_served']}; ttft p50 hit/miss: "
              f"{out['ttft_hit_p50'] * 1e3:.1f} / "
              f"{out['ttft_miss_p50'] * 1e3:.1f} ms")
    if args.max_queue is not None or args.deadline_ms is not None \
            or out["fault_events"] or out["prefix_lookup_failures"] \
            or out["checksum_failures"] or out["spec_watchdog_trips"]:
        print(f"robustness: {out['shed_count']} shed, "
              f"{out['deadline_count']} deadline-expired, "
              f"{out['fault_events']} fault events "
              f"({out['fault_recoveries']} recovered, "
              f"{out['fault_finishes']} gave up), "
              f"{out['prefix_lookup_failures']} prefix-lookup failures, "
              f"{out['checksum_failures']} checksum failures, "
              f"{out['spec_watchdog_trips']} spec-watchdog trips")
    if args.verify:
        status = ("OK" if out["verified"]
                  else f"MISMATCH rids={out['mismatched_rids']}")
        if out["verify_skipped_rids"]:
            status += (f" ({len(out['verify_skipped_rids'])} requests "
                       "skipped: no natural finish)")
        print(f"scheduler vs lockstep token equivalence: {status}")

    m = args.max_prompt + args.gen
    full = kv_traffic_bytes(m, cfg.hd, m, with_lop=False)
    lop = kv_traffic_bytes(m, cfg.hd, int(m * cfg.lop_keep), with_lop=True)
    print(f"modeled KV traffic/head/query: {full} B dense → {lop} B with LOP"
          f" ({full / lop:.1f}× reduction at keep={cfg.lop_keep})")
    return 0 if not args.verify or out["verified"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
