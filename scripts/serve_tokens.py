"""Tokens of ``chip_smoke.py``'s serve runs, as digests, for one build of
the port.

    PYTHONPATH=<tree>/src python3 scripts/serve_tokens.py [--dump FILE]
        [--against FILE ...] [--plain-decode] [--profile]

Serves ``chip_smoke.py``'s 8 seeded requests on full-width bitnet-3b
(seeded random weights) through the Scheduler on one CUDA card three
times — greedy with LOP decode (phase 4), greedy with dense decode
(phase 4b) and sampled with LOP (phase 4c) — and prints one ``tokens
sha256`` line per run (``chip_smoke.tokens_digest``). ``repro_torch`` is
imported from ``PYTHONPATH``, so running this script against two trees'
``src`` in one call shows whether a change keeps every token.

``--dump FILE`` writes every run's tokens as JSON; ``--against FILE``
(repeatable) compares them with another build's dump and, for each run
whose tokens differ, prints the first request and token where they part
and the gap between the two largest logits there on this build (the
request replayed alone through ``lockstep_generate``, which the scheduler
matches bitwise): a gap at the rounding level shows a near-tie, not a
fault. ``--plain-decode`` serves with the plain PyTorch decode attention
(``kernels/ref.py``) on the card in place of the two decode kernels,
eagerly (no CUDA graphs), as a third stream that both builds' streams can
be held against.
``--profile`` then times a decode step over 4 active lanes (no prefill in
flight) on the LOP and the dense engine and profiles 4 such steps each
(``chip_smoke.profile_steps``: device time a step, by kernel), so two
builds' step device times can be compared in one call.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as smoke  # noqa: E402


def first_difference(mine: dict, theirs: dict):
    """(rid, token index) of the first token where two dumps of one run
    differ, rids in order; None where they agree."""
    for rid in sorted(set(mine) | set(theirs), key=int):
        a, b = mine.get(rid, []), theirs.get(rid, [])
        for i in range(max(len(a), len(b))):
            if i >= len(a) or i >= len(b) or a[i] != b[i]:
                return rid, i
    return None


def top2_gaps(torch, engine, req) -> tuple[list, list]:
    """Replay ``req`` alone through ``lockstep_generate`` on an eager twin
    of ``engine`` (the same weights; its steps run the Python that a CUDA
    graph only records, bitwise the graphs' tokens). → (its tokens, the
    gap between the two largest logits at each token)."""
    from repro_torch.serving.api import PooledEngine
    from repro_torch.serving.scheduler import lockstep_generate

    engine = PooledEngine(engine.cfg, engine.qp, max_len=engine.max_len,
                          use_lop=engine.use_lop, device=engine.device,
                          graphs=False)
    gaps = []
    pick, first = engine._pick, engine.sample_first

    def record(logits):
        top = torch.topk(logits[0].float(), 2).values
        gaps.append(float(top[0] - top[1]))

    def _pick(logits, *a, **kw):
        record(logits)
        return pick(logits, *a, **kw)

    def _first(logits, *a, **kw):
        record(logits)
        return first(logits, *a, **kw)

    engine._pick, engine.sample_first = _pick, _first
    toks = lockstep_generate(engine, req.prompt, req.max_new_tokens,
                             eos_id=req.eos_id, sampling=req.sampling)
    return toks, gaps


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dump", help="write every run's tokens here (JSON)")
    ap.add_argument("--against", action="append", default=[],
                    help="compare with this dump (repeatable)")
    ap.add_argument("--plain-decode", action="store_true",
                    help="decode attention through the plain version")
    ap.add_argument("--profile", action="store_true",
                    help="profile decode steps of the LOP and dense engines")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        return smoke.fail("torch.cuda.is_available() is false: no CUDA card")
    import repro_torch
    if args.plain_decode:
        from repro_torch.kernels import ops
        from repro_torch.kernels import ref as plain

        def decode_attention(*a, softmax_scale=None, **kw):
            scale = a[0].shape[-1] ** -0.5 if softmax_scale is None \
                else softmax_scale
            return plain.decode_attention_ref(
                *a[:7], a[7].to(torch.int32), softmax_scale=scale, **kw)
        ops.decode_attention = decode_attention
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_requests
    from repro_torch.serving.api import PooledEngine, SamplingParams

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    smoke.log(f"repro_torch from {Path(repro_torch.__file__).parent} [{card}]")
    cfg = get_config("bitnet-3b")
    engine = PooledEngine.from_seed(cfg, seed=smoke.SEED,
                                    max_len=smoke.MAX_PROMPT + smoke.GEN,
                                    device="cuda",
                                    graphs=not args.plain_decode)
    reqs = make_requests(cfg, n_requests=smoke.N_REQUESTS,
                         min_prompt=smoke.MIN_PROMPT,
                         max_prompt=smoke.MAX_PROMPT, gen=smoke.GEN,
                         seed=smoke.SEED)
    dense = PooledEngine(cfg, engine.qp, max_len=engine.max_len,
                         use_lop=False, device="cuda",
                         graphs=not args.plain_decode)
    sampled = [replace(r, sampling=SamplingParams(
        temperature=0.8, top_k=50, top_p=0.95, seed=r.rid)) for r in reqs]
    runs = (("LOP greedy", engine, reqs), ("no-LOP greedy", dense, reqs),
            ("LOP sampled", engine, sampled))
    tokens = {}
    for label, eng, rs in runs:
        results = smoke.serve_run(torch, np, eng, rs, label, card)["results"]
        tokens[label] = {str(rid): [int(t) for t in r.tokens]
                         for rid, r in results.items()}
    if args.dump:
        Path(args.dump).write_text(json.dumps(tokens))
    for against in args.against:
        theirs = json.loads(Path(against).read_text())
        for label, eng, rs in runs:
            where = first_difference(tokens[label], theirs[label])
            if where is None:
                smoke.log(f"  [{label}] tokens equal to {against}")
                continue
            rid, i = where
            req = next(r for r in rs if str(r.rid) == rid)
            toks, gaps = top2_gaps(torch, eng, req)
            mine, other = tokens[label][rid], theirs[label].get(rid, [])
            smoke.log(
                f"  [{label}] first differs from {against} at rid {rid}"
                f" token {i}: {mine[i] if i < len(mine) else None} here, "
                f"{other[i] if i < len(other) else None} there; top-2 logit "
                f"gap there on this build {gaps[i]:.6g} (lockstep replay "
                f"{'==' if toks == mine else '!='} the scheduler's stream; "
                f"median gap over the request {float(np.median(gaps)):.6g})")
    if args.profile:
        for label, eng in (("LOP greedy", engine), ("no-LOP greedy", dense)):
            step_ms, sched = smoke.decode_step_ms(torch, np, eng, reqs)
            smoke.log(f"  decode step (B={smoke.N_SLOTS}, no prefill in "
                      f"flight), {label}: p50 {step_ms:.2f} ms [{card}]")
            smoke.profile_steps(torch, sched, label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
