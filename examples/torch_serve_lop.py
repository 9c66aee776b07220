"""Serve a small model with batched requests on the PyTorch port, ablating
the LOP screen.

    PYTHONPATH=src python examples/torch_serve_lop.py \\
        [--arch mistral-nemo-12b] [--device cpu]

Part 1 runs the same batch with (a) dense int8 decode attention and (b) LOP
predictive sparse attention at several keep fractions, reporting decode
wall time and the modeled KV traffic — the serving-side view of Fig. 8.
Part 2 pushes a mixed-prompt-length request stream through the slot-paged
continuous-batching scheduler and checks every request against its solo
lockstep run — the serving-engine view of the same screen.
Part 3 exercises the typed serving API: seeded temperature/top-k sampling
through the continuous-batching pool, with every request verified
token-identical against its lockstep replay and inter-token-latency
percentiles reported.

Runs on the CUDA card unless ``--device cpu`` asks for the plain PyTorch
versions of the kernels. The JAX reference counts the prefill shapes it
compiled; the port compiles none, and reports instead the decode steps it
holds as CUDA graphs (none on the CPU, where every step runs eagerly).
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import resolve_config
from repro_torch.core.lop import kv_traffic_bytes
from repro_torch.device import resolve_device
from repro_torch.launch.serve import make_requests, serve_loop
from repro_torch.serving.api import PooledEngine, SamplingParams
from repro_torch.serving.engine import prefill, serve_step
from repro_torch.serving.quantize import init_serving_params


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cfg, qp, prompts, gen, use_lop):
    """Whole prefill, then ``gen`` greedy decode steps. → (tokens [B,
    gen], decode wall seconds)."""
    logits, cache = prefill(cfg, qp, prompts,
                            max_len=prompts.shape[1] + gen)
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    toks = []
    _sync(prompts.device)
    t0 = time.time()
    for _ in range(gen):
        toks.append(tok.cpu().numpy())
        logits, cache = serve_step(cfg, qp, cache, tok, use_lop=use_lop)
        tok = logits.argmax(-1)[:, None].to(torch.int32)
    _sync(prompts.device)
    return np.concatenate(toks, 1), time.time() - t0


def keep_ablation(base, qp, args, device) -> dict:
    """Dense decode, then LOP at keep 1.0 / 0.5 / 0.25 on the same batch.
    → {keep: token agreement with dense}."""
    rng = np.random.default_rng(1)
    prompts = torch.from_numpy(rng.integers(
        0, base.vocab, (args.batch, args.prompt_len)).astype(np.int32)
    ).to(device)
    m = args.prompt_len + args.gen
    ref_toks, t_dense = run(base, qp, prompts, args.gen, use_lop=False)
    print(f"dense decode:            {t_dense:.2f}s")
    agreement = {}
    for keep in (1.0, 0.5, 0.25):
        cfg = base.replace(lop_keep=keep)
        toks, t = run(cfg, qp, prompts, args.gen, use_lop=True)
        agree = float((toks == ref_toks).mean())
        traffic = kv_traffic_bytes(m, cfg.hd, int(keep * m), with_lop=True)
        dense_traffic = kv_traffic_bytes(m, cfg.hd, m, with_lop=False)
        print(f"LOP keep={keep:4.2f} decode:  {t:.2f}s  "
              f"token agreement {agree:5.1%}  "
              f"KV traffic ÷{dense_traffic / traffic:.1f}")
        agreement[keep] = agree
    return agreement


def _graphs_held(engine) -> str:
    graphs = engine.graphs
    if graphs is None:
        return "no CUDA graphs (every step eager)"
    return f"{len(graphs)} decode step keys held as CUDA graphs"


def continuous_batching_demo(engine, args) -> dict:
    """Slot-paged scheduler over mixed prompt lengths + solo cross-check
    (the full driver: serve_loop's per-request lockstep replay)."""
    reqs = make_requests(engine.cfg, n_requests=args.batch * 2,
                         min_prompt=max(args.prompt_len // 4, 4),
                         max_prompt=args.prompt_len, gen=args.gen, seed=1)
    out = serve_loop(engine, reqs, n_slots=args.batch, verify=True)
    agree = len(out["results"]) - len(out["mismatched_rids"])
    print(f"continuous batching: {len(out['results'])} reqs on "
          f"{args.batch} lanes, {out['wall_s']:.2f}s wall, "
          f"{_graphs_held(engine)}")
    print(f"  lockstep agreement {agree}/{len(out['results'])}; latency "
          f"p50 {out['latency_p50'] * 1e3:.0f} ms, p99 "
          f"{out['latency_p99'] * 1e3:.0f} ms")
    return dict(out, agree=agree)


def sampled_api_demo(engine, args) -> dict:
    """Typed-API part: per-request SamplingParams through the pool, each
    request verified against its same-seed lockstep replay."""
    reqs = make_requests(engine.cfg, n_requests=args.batch,
                         min_prompt=max(args.prompt_len // 4, 4),
                         max_prompt=args.prompt_len, gen=args.gen, seed=1,
                         sampling=SamplingParams(temperature=0.8, top_k=8,
                                                 seed=7))
    out = serve_loop(engine, reqs, n_slots=args.batch, verify=True)
    agree = len(out["results"]) - len(out["mismatched_rids"])
    print(f"sampled serving (T=0.8 top_k=8, per-request seeds): "
          f"{agree}/{len(out['results'])} pool == same-seed lockstep; "
          f"itl p50 {out['itl_p50'] * 1e3:.0f} ms, p99 "
          f"{out['itl_p99'] * 1e3:.0f} ms")
    return dict(out, agree=agree)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mistral-nemo-12b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=96)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def demo(args) -> dict:
    """The three parts on the reduced ``--arch``, its weights drawn from
    seed 0. → {"agreement": {keep: share}, "batching": serve_loop stats,
    "sampled": serve_loop stats}."""
    device = resolve_device(args.device)
    base = resolve_config(args.arch, reduced=True)
    qp = init_serving_params(base, 0, device)
    agreement = keep_ablation(base, qp, args, device)
    engine = PooledEngine(base, qp, max_len=args.prompt_len + args.gen,
                          device=device)
    batching = continuous_batching_demo(engine, args)
    sampled = sampled_api_demo(engine, args)
    return {"agreement": agreement, "batching": batching,
            "sampled": sampled}


def main(argv=None) -> int:
    out = demo(parse_args(argv))
    full = all(out[part]["agree"] == len(out[part]["results"])
               for part in ("batching", "sampled"))
    return 0 if full else 1


if __name__ == "__main__":
    raise SystemExit(main())
