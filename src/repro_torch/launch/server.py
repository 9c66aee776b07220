"""Launch the port's production HTTP serving front-end.

    PYTHONPATH=src python -m repro_torch.launch.server --arch bitnet-3b \\
        [--reduced] [--device cpu] --port 8000

builds a seeded model on the device (the CUDA card unless ``--device cpu``;
without a card and without ``--device cpu`` it raises) and serves it. Then
stream a completion (the wire speaks token ids — the repo has no
tokenizer):

    curl -N http://127.0.0.1:8000/v1/completions \\
        -d '{"prompt": [17, 42, 99], "max_tokens": 8, "stream": true}'

``GET /metrics`` serves the Prometheus-text registry the scheduler writes
into: the series ``repro_torch.launch.serve`` reports, under the names
``repro.launch.server`` exports, so a serve-loop run, a live server and the
JAX reference's server are diffable dashboards. ``--shape-log PATH`` arms
the tile autotuner's shape log: every distinct kernel dispatch shape the
engine runs lands in that JSON file, which ``python -m
repro_torch.kernels.autotune --from-log PATH`` later sweeps on the card.
"""

from __future__ import annotations

import argparse
import asyncio

from repro_torch.configs import resolve_config
from repro_torch.serving.api import PooledEngine
from repro_torch.serving.frontend import HttpFrontend
from repro_torch.serving.metrics import REGISTRY
from repro_torch.serving.scheduler import Scheduler


def build_scheduler(args) -> Scheduler:
    cfg = resolve_config(args.arch, args.reduced)
    engine = PooledEngine.from_seed(cfg, seed=args.seed, max_len=args.max_len,
                                    device=args.device,
                                    use_lop=not args.no_lop,
                                    chunk_tokens=args.chunk_tokens,
                                    draft_layers=args.draft_layers,
                                    draft_k=args.draft_k,
                                    shape_log=args.shape_log)
    return Scheduler(engine, n_slots=args.slots, max_queue=args.max_queue,
                     chunked=not args.no_chunked,
                     prefix_cache=not args.no_prefix_cache,
                     spec_decode=args.spec_decode, gamma=args.gamma,
                     metrics=REGISTRY)


async def amain(args) -> None:
    sched = build_scheduler(args)
    frontend = HttpFrontend(sched, model_name=args.model_name or args.arch,
                            registry=REGISTRY)
    port = await frontend.start(args.host, args.port)
    print(f"serving {args.arch}{' (reduced)' if args.reduced else ''} on "
          f"{sched.engine.device} at http://{args.host}:{port}", flush=True)
    print(f"  curl -N http://{args.host}:{port}/v1/completions "
          "-d '{\"prompt\": [17, 42, 99], \"max_tokens\": 8, "
          "\"stream\": true}'", flush=True)
    print(f"  curl http://{args.host}:{port}/metrics", flush=True)
    await frontend.serve_forever()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="bitnet-3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000,
                    help="0 picks a free port")
    ap.add_argument("--model-name", default=None,
                    help="name reported by /v1/models (default: --arch)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=2048,
                    help="per-slot KV capacity (prompt + generation)")
    ap.add_argument("--max-queue", type=int, default=64,
                    help="admission bound; beyond it requests get 429")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-lop", action="store_true")
    ap.add_argument("--no-chunked", action="store_true",
                    help="prefill every prompt whole at its exact length")
    ap.add_argument("--chunk-tokens", type=int, default=None,
                    help="prefill chunk size (default: the arch's lop_block)")
    ap.add_argument("--no-prefix-cache", action="store_true")
    ap.add_argument("--spec-decode", action="store_true")
    ap.add_argument("--gamma", type=int, default=4)
    ap.add_argument("--draft-layers", type=int, default=None)
    ap.add_argument("--draft-k", type=int, default=None)
    ap.add_argument("--shape-log", default=None,
                    help="JSON sidecar recording kernel dispatch shapes "
                         "(swept later by python -m "
                         "repro_torch.kernels.autotune --from-log)")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    try:
        asyncio.run(amain(args))
    except KeyboardInterrupt:
        print("shutting down")


if __name__ == "__main__":
    main()
