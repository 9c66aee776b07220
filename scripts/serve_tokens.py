"""Tokens of ``chip_smoke.py``'s serve runs, as digests, for one build of
the port.

    PYTHONPATH=<tree>/src python3 scripts/serve_tokens.py

Serves ``chip_smoke.py``'s 8 seeded requests on full-width bitnet-3b
(seeded random weights) through the Scheduler on one CUDA card three
times — greedy with LOP decode (phase 4), greedy with dense decode
(phase 4b) and sampled with LOP (phase 4c) — and prints one ``tokens
sha256`` line per run (``chip_smoke.tokens_digest``). ``repro_torch`` is
imported from ``PYTHONPATH``, so running this script against two trees'
``src`` in one call shows whether a change keeps every token.
"""

from __future__ import annotations

import subprocess
import sys
from dataclasses import replace
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as smoke  # noqa: E402


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        return smoke.fail("torch.cuda.is_available() is false: no CUDA card")
    import repro_torch
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
                                    device="cuda")
    reqs = make_requests(cfg, n_requests=smoke.N_REQUESTS,
                         min_prompt=smoke.MIN_PROMPT,
                         max_prompt=smoke.MAX_PROMPT, gen=smoke.GEN,
                         seed=smoke.SEED)
    smoke.serve_run(torch, np, engine, reqs, "LOP greedy", card)
    dense = PooledEngine(cfg, engine.qp, max_len=engine.max_len,
                         use_lop=False, device="cuda")
    smoke.serve_run(torch, np, dense, reqs, "no-LOP greedy", card)
    sampled = [replace(r, sampling=SamplingParams(
        temperature=0.8, top_k=50, top_p=0.95, seed=r.rid)) for r in reqs]
    smoke.serve_run(torch, np, engine, sampled, "LOP sampled", card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
