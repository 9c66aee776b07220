"""Continuous-batching serving entry point of the port.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch bitnet-3b \\
        --slots 4 --requests 8 --gen 32 [--reduced] [--device cpu] \\
        [--no-lop] [--temperature T --top-k K --top-p P --sample-seed S] \\
        [--max-queue N] [--deadline-ms MS] [--stream] [--verify]

Builds a seeded model on the device (the CUDA card unless ``--device cpu``),
synthesizes requests with prompt lengths drawn from
``numpy.random.default_rng(seed)``, serves them through the
:class:`repro_torch.serving.scheduler.Scheduler` (chunked prefill
interleaved with decode) and reports tokens/s, TTFT, latency, the time
of a serve cycle's decode call and, last, the modeled K/V traffic per
head and query, dense against LOP. ``--no-lop`` decodes with dense attention
(the LOP ablation arm); the sampling flags give every request the same
policy, request ``rid`` sampling under seed ``sample_seed + rid``.
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
from repro_torch.serving.scheduler import Scheduler, lockstep_generate


def make_requests(cfg, *, n_requests: int, min_prompt: int, max_prompt: int,
                  gen: int, seed: int = 0,
                  sampling: SamplingParams | None = None,
                  deadline_ms: float | None = None, on_token=None) -> list:
    """Prompts of ``[min_prompt, max_prompt]`` random tokens, FIFO order.
    With ``sampling`` given, request ``rid`` samples under seed
    ``sampling.seed + rid``."""
    if not 0 < min_prompt <= max_prompt:
        raise ValueError(f"need 0 < min_prompt <= max_prompt, got "
                         f"{min_prompt}..{max_prompt}")
    rng = np.random.default_rng(seed)
    reqs = []
    for rid in range(n_requests):
        plen = int(rng.integers(min_prompt, max_prompt + 1))
        prompt = rng.integers(0, cfg.vocab, (plen,)).astype(np.int32)
        sp = SamplingParams() if sampling is None else \
            replace(sampling, seed=sampling.seed + rid)
        reqs.append(GenerateRequest(rid=rid, prompt=prompt,
                                    max_new_tokens=gen, sampling=sp,
                                    deadline_ms=deadline_ms,
                                    on_token=on_token))
    return reqs


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_loop(engine: PooledEngine, reqs: list, *, n_slots: int,
               max_queue: int | None = None, verify: bool = False) -> dict:
    """Serve ``reqs`` (all arriving at t0) → stats dict."""
    sched = Scheduler(engine, n_slots=n_slots, max_queue=max_queue)
    _sync(engine.device)
    t0 = time.monotonic()
    for req in reqs:
        sched.submit(req)
    results = sorted(sched.run_to_completion(), key=lambda r: r.rid)
    _sync(engine.device)
    wall = time.monotonic() - t0
    n_tok = sum(len(r.tokens) for r in results)
    ttft = [r.ttft for r in results if r.tokens] or [float("nan")]
    out = {
        "results": results,
        "tokens": {r.rid: list(r.tokens) for r in results},
        "wall_s": wall,
        "tokens_per_s": n_tok / max(wall, 1e-9),
        "ttft_p50_s": float(np.percentile(ttft, 50)),
        "latency_p50_s": float(np.percentile([r.latency for r in results],
                                             50)),
        "serve_cycle_decode_ms_p50": float(np.percentile(
            sched.decode_seconds, 50) * 1e3) if sched.decode_seconds
        else float("nan"),
        "decode_steps": sched.decode_steps,
        "shed_count": sched.shed_count,
        "deadline_count": sched.deadline_count,
        "fault_events": sched.fault_events,
        "fault_recoveries": sched.fault_recoveries,
        "fault_finishes": sched.fault_finishes,
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
                                    stop=req.stop)
            if out["tokens"][req.rid] != ref:
                mismatched.append(req.rid)
        out["verified"] = not mismatched
        out["mismatched_rids"] = mismatched
        out["verify_skipped_rids"] = skipped
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="bitnet-3b")
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
    max_len = args.max_prompt + args.gen
    engine = PooledEngine.from_seed(cfg, seed=args.seed, max_len=max_len,
                                    device=args.device,
                                    use_lop=not args.no_lop)
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
                         deadline_ms=args.deadline_ms, on_token=on_token)
    mode = "greedy" if sampling.greedy else (
        f"T={sampling.temperature} top_k={sampling.top_k} "
        f"top_p={sampling.top_p}")
    print(f"serving {cfg.name} on {engine.device}: {args.slots} slots, "
          f"{args.requests} requests (prompts {args.min_prompt}-"
          f"{args.max_prompt}, gen {args.gen}), lop="
          f"{'off' if args.no_lop else 'on'}, sampling {mode}")
    out = serve_loop(engine, reqs, n_slots=args.slots,
                     max_queue=args.max_queue, verify=args.verify)
    for r in out["results"]:
        print(f"rid {r.rid:>3} prompt {r.prompt_len:>5} tokens "
              f"{len(r.tokens):>4} ttft {r.ttft * 1e3:9.1f} ms latency "
              f"{r.latency * 1e3:9.1f} ms  {r.finish_reason}")
    print(f"wall {out['wall_s']:.3f} s, {out['tokens_per_s']:.1f} tok/s, "
          f"ttft p50 {out['ttft_p50_s'] * 1e3:.1f} ms, latency p50 "
          f"{out['latency_p50_s'] * 1e3:.1f} ms, serve-cycle decode "
          f"p50 {out['serve_cycle_decode_ms_p50']:.2f} ms (waits on the "
          f"cycle's prefill chunk)")
    if args.max_queue is not None or args.deadline_ms is not None \
            or out["fault_events"]:
        print(f"robustness: {out['shed_count']} shed, "
              f"{out['deadline_count']} deadline-expired, "
              f"{out['fault_events']} fault events "
              f"({out['fault_recoveries']} recovered, "
              f"{out['fault_finishes']} gave up)")
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
