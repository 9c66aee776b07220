"""Continuous-batching serving entry point of the port.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch bitnet-3b \\
        --slots 4 --requests 8 --gen 32 [--reduced] [--device cpu] [--verify]

Builds a seeded model on the device (the CUDA card unless ``--device cpu``),
synthesizes requests with prompt lengths drawn from
``numpy.random.default_rng(seed)``, serves them through the
:class:`repro_torch.serving.scheduler.Scheduler` (chunked prefill
interleaved with greedy decode) and reports tokens/s, TTFT and the time
of a serve cycle's decode call. ``--verify`` replays every request alone through
:func:`lockstep_generate` and checks token-exact agreement.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import resolve_config
from repro_torch.serving.api import GenerateRequest, PooledEngine
from repro_torch.serving.scheduler import Scheduler, lockstep_generate


def make_requests(cfg, *, n_requests: int, min_prompt: int, max_prompt: int,
                  gen: int, seed: int = 0) -> list:
    """Prompts of ``[min_prompt, max_prompt]`` random tokens, FIFO order."""
    if not 0 < min_prompt <= max_prompt:
        raise ValueError(f"need 0 < min_prompt <= max_prompt, got "
                         f"{min_prompt}..{max_prompt}")
    rng = np.random.default_rng(seed)
    reqs = []
    for rid in range(n_requests):
        plen = int(rng.integers(min_prompt, max_prompt + 1))
        prompt = rng.integers(0, cfg.vocab, (plen,)).astype(np.int32)
        reqs.append(GenerateRequest(rid=rid, prompt=prompt,
                                    max_new_tokens=gen))
    return reqs


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_loop(engine: PooledEngine, reqs: list, *, n_slots: int,
               verify: bool = False) -> dict:
    """Serve ``reqs`` (all arriving at t0) → stats dict."""
    sched = Scheduler(engine, n_slots=n_slots)
    _sync(engine.device)
    t0 = time.monotonic()
    for req in reqs:
        sched.submit(req)
    results = sorted(sched.run_to_completion(), key=lambda r: r.rid)
    _sync(engine.device)
    wall = time.monotonic() - t0
    n_tok = sum(len(r.tokens) for r in results)
    out = {
        "results": results,
        "tokens": {r.rid: list(r.tokens) for r in results},
        "wall_s": wall,
        "tokens_per_s": n_tok / max(wall, 1e-9),
        "ttft_p50_s": float(np.percentile([r.ttft for r in results], 50)),
        "serve_cycle_decode_ms_p50": float(np.percentile(
            sched.decode_seconds, 50) * 1e3) if sched.decode_seconds
        else float("nan"),
        "decode_steps": sched.decode_steps,
    }
    if verify:
        mismatched = [r.rid for r, req in zip(results, reqs)
                      if r.tokens != lockstep_generate(
                          engine, req.prompt, req.max_new_tokens)]
        out["verified"] = not mismatched
        out["mismatched_rids"] = mismatched
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
    ap.add_argument("--verify", action="store_true",
                    help="replay each request alone (lockstep) and check "
                         "token-exact agreement")
    args = ap.parse_args(argv)

    cfg = resolve_config(args.arch, args.reduced)
    max_len = args.max_prompt + args.gen
    engine = PooledEngine.from_seed(cfg, seed=args.seed, max_len=max_len,
                                    device=args.device)
    reqs = make_requests(cfg, n_requests=args.requests,
                         min_prompt=args.min_prompt,
                         max_prompt=args.max_prompt, gen=args.gen,
                         seed=args.seed + 1)
    print(f"serving {cfg.name} on {engine.device}: {args.slots} slots, "
          f"{args.requests} requests (prompts {args.min_prompt}-"
          f"{args.max_prompt}, gen {args.gen})")
    out = serve_loop(engine, reqs, n_slots=args.slots, verify=args.verify)
    for r in out["results"]:
        print(f"rid {r.rid:>3} prompt {r.prompt_len:>5} tokens "
              f"{len(r.tokens):>4} ttft {r.ttft * 1e3:9.1f} ms  "
              f"{r.finish_reason}")
    print(f"wall {out['wall_s']:.3f} s, {out['tokens_per_s']:.1f} tok/s, "
          f"ttft p50 {out['ttft_p50_s'] * 1e3:.1f} ms, serve-cycle decode "
          f"p50 {out['serve_cycle_decode_ms_p50']:.2f} ms (waits on the "
          f"cycle's prefill chunk)")
    if args.verify:
        print("scheduler vs lockstep token equivalence: "
              + ("OK" if out["verified"]
                 else f"MISMATCH rids={out['mismatched_rids']}"))
        return 0 if out["verified"] else 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
