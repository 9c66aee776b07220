"""Tabulate a directory of dry-run cells (``python -m
repro_torch.launch.dryrun --both-meshes --out DIR``) as one markdown row
an architecture, one column a shape × mesh: the per-rank peak in GiB,
whether it fits one card (✓ / ✗), the dominant roofline term (c compute,
m memory, n collective) and the trace seconds; a skipped cell prints
``skip``, a failed one ``FAIL``.

    python scripts/dryrun_table.py DIR
"""

import json
import sys
from pathlib import Path

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
MESHES = ("sp", "mp")
TERM = {"compute_s": "c", "memory_s": "m", "collective_s": "n"}


def cell(path: Path) -> str:
    if not path.exists():
        return "—"
    r = json.loads(path.read_text())
    if r["status"] != "ok":
        return r["status"] if r["status"] == "skip" else "FAIL"
    peak = r["memory"]["peak_estimate_bytes"] / 2**30
    return (f"{peak:.2f} {'✓' if r['fits'] else '✗'} "
            f"{TERM[r['roofline']['dominant']]} {r['trace_s']}")


def main(argv=None) -> int:
    d = Path((argv or sys.argv[1:])[0])
    archs = sorted({p.name.split("__")[0] for p in d.glob("*__*.json")})
    cols = [f"{s} {m}" for s in SHAPES for m in MESHES]
    print("| arch | " + " | ".join(cols) + " |")
    print("|---|" + "---|" * len(cols))
    for arch in archs:
        print(f"| {arch} | " + " | ".join(
            cell(d / f"{arch}__{s}__{m}.json") for s in SHAPES
            for m in MESHES) + " |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
