"""CUDA graphs of the engine's decode entries — the port's counterpart of
the reference's ``jax.jit(step, donate_argnums=(1,))`` decode functions
(``src/repro/serving/api.py``: greedy and sampled decode, greedy and
sampled retry).

A graph replays the kernels it recorded on the addresses it recorded: the
weights, every pool tensor (which the step updates in place and never
rebinds — the counterpart of donation), one static input buffer that each
replay refills with one host-to-device copy, and the step's output. So a
graph serves one (entry, pool) and is keyed on the entry and on every pool
tensor's address, shape, strides and dtype (:func:`graph_key`); a key built
again on reused addresses with the same layout names the same graph, which
then reads and writes the same tensors.

Per key: the first call runs the step eagerly on the capture stream — it
builds the kernels' libraries, raises their shared-memory limits, fills the
launch-plan caches and sets up cuBLAS for the f32 head, and its result is
the step's result; the second call captures (no kernel runs, so the pool
does not move) and replays; every later call replays. No pool is stepped
twice. An engine keeps at most :data:`GRAPH_BOUND` (8) keys, warmed or
captured; the least recently used goes first, with its graph.

The kernel wrappers count launches on the host, so they count at capture
and never at replay: the capture's counts are taken back and every replay
adds its graph's (:func:`repro_torch.kernels.ops.add_launches`), so
``ops.launch_counts()`` still counts launches.

Nothing here falls back to the eager step: a failed capture or replay
raises.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels import ops

# keys (warmed or captured) kept per engine; the least recently used goes,
# with its graph and the memory the graph holds
GRAPH_BOUND = 8


def _tensors(tree, prefix=""):
    for name in sorted(tree):
        val = tree[name]
        if isinstance(val, dict):
            yield from _tensors(val, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", val


def graph_key(entry: str, pool: dict) -> tuple:
    """The entry, the batch and every pool tensor's (name, address, shape,
    strides, dtype): what a graph recorded on ``pool`` depends on."""
    return (entry, int(pool["lengths"].shape[0]),
            *((name, t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
              for name, t in _tensors(pool)))


@dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    inp: torch.Tensor               # the static input buffer
    out: torch.Tensor               # the static output
    launches: dict                  # kernel name → launches a replay makes
    nbytes: int                     # device memory its private pool reserved


class StepGraphs:
    """The captured decode entries of one engine on one card, at most
    :data:`GRAPH_BOUND` keys at a time.

    ``run(step, entry, pool, host)`` computes ``step(pool, inp, entry)``
    with ``inp`` the int32 host array ``host`` on the card, and returns
    its output tensor (valid until the next call).
    """

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        self._live: OrderedDict = OrderedDict()   # key → _Graph | None

    @property
    def count(self) -> int:
        """Graphs held now."""
        return sum(g is not None for g in self._live.values())

    @property
    def nbytes(self) -> int:
        """Device memory the held graphs reserved at capture."""
        return sum(g.nbytes for g in self._live.values() if g is not None)

    def __len__(self) -> int:
        return len(self._live)

    def run(self, step, entry: str, pool: dict, host: np.ndarray):
        key = graph_key(entry, pool)
        if key not in self._live:
            out = self._warm(step, entry, pool, host)
            self._live[key] = None
            while len(self._live) > GRAPH_BOUND:
                self._live.popitem(last=False)
            return out
        self._live.move_to_end(key)
        graph = self._live[key]
        if graph is None:
            graph = self._live[key] = self._capture(step, entry, pool, host)
        return self._replay(graph, host)

    def _warm(self, step, entry, pool, host):
        """The eager step on the capture stream."""
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = step(pool, self._upload(host), entry)
        cur.wait_stream(self.stream)
        out.record_stream(cur)
        return out

    def _capture(self, step, entry, pool, host) -> _Graph:
        inp = self._upload(host)
        before = ops.launch_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=self.stream):
                held = torch.cuda.memory_reserved(self.device)
                out = step(pool, inp, entry)
            nbytes = torch.cuda.memory_reserved(self.device) - held
        finally:
            after = ops.launch_counts()
            launches = {k: after[k] - before[k] for k in after
                        if after[k] != before[k]}
            ops.add_launches({k: -n for k, n in launches.items()})
        return _Graph(graph, inp, out, launches, nbytes)

    def _replay(self, graph: _Graph, host):
        graph.inp.copy_(torch.from_numpy(host), non_blocking=True)
        graph.graph.replay()
        ops.add_launches(graph.launches)
        return graph.out

    def _upload(self, host) -> torch.Tensor:
        return torch.from_numpy(host).to(self.device, non_blocking=True)
