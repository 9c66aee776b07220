"""One rank's program traced on the ``meta`` device — the counterpart of
the reference's ``repro/analysis/hlo.py``.

The reference reads its costs off XLA: ``cost_analysis()`` for FLOPs and
bytes, regexes over the compiled HLO text for the collectives and the
fused-HBM bytes, ``memory_analysis()`` for the memory. The port has no
compiler and no HLO text: it runs the rank's eager program on ``meta``
tensors (shapes and dtypes, no storage, no arithmetic) under
:class:`OpTrace`, a ``TorchDispatchMode`` that sees every aten op the
program dispatches, forward and backward, and records

* FLOPs through ``torch.utils.flop_counter``'s registry (matmuls,
  convolutions; elementwise ops count none, as there);
* raw bytes: operands plus results of every op that is not a view — the
  eager port's own traffic, the counterpart of ``cost_analysis()['bytes
  accessed']``;
* fused-HBM bytes (:func:`hbm_bytes`, the reference's fused model);
* the kernel entries' records (:mod:`repro_torch.kernels.ops`: on a meta
  tensor under a trace each entry makes its outputs' shapes and records
  ``(kernel, mode, analysis.roofline.kernel_cost(...))``), by the keys of
  ``ops.launch_counts(modes=True)``;
* the collectives of an abstract mesh
  (:mod:`repro_torch.distributed.partitioning`): ``(kind, result bytes
  on one rank)`` under the reference's kind names;
* live bytes by storage, allocated as an op's result makes a storage and
  freed as the last tensor holding it dies (a weakref finalizer on the
  storage), each rounded up to the caching allocator's 512 bytes; their
  peak and the arguments' bytes give the reference's ``memory`` keys
  (:meth:`OpTrace.memory`).

Nothing is recorded in aggregate that depends on values: a meta tensor
has none, so a program that reads one (``.item()``) raises.
"""

from __future__ import annotations

import weakref
from contextlib import contextmanager

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# the reference's kind names (its analysis/hlo.py)
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

# the caching allocator's block granularity (bytes)
ALLOC_ROUND = 512

# The fused model, aten op → category. Every op named here touches HBM
# with its operands and result, as the reference's ``_HBM_OPS`` (fusion,
# dot, convolution, reduce, gather, scatter, transpose, concatenate, pad,
# reverse, sort, …) do; a write into part of a tensor counts its update
# (and indices) only, the reference's dynamic-update-slice rule; every
# other op is bare elementwise (or a factory, a view) and counts as fused:
#
#   matmul        mm, bmm, addmm, baddbmm, _int_mm, convolution
#   reduction     sum, mean, amax, amin, max, min, prod, var, std,
#                 var_mean, norm, linalg_vector_norm, argmax, argmin,
#                 all, any, cumsum, cumprod, logsumexp, _softmax,
#                 _log_softmax and their backward ops
#   gather        index, index_select, gather, embedding,
#                 embedding_dense_backward, take, masked_select
#   scatter       scatter, scatter_add, scatter_reduce, index_add
#   movement      cat, stack, constant_pad_nd, flip, roll, repeat,
#                 clone (a materialized copy)
#   sort          sort, topk, argsort
#   update        copy_, index_put, index_copy, slice_scatter,
#                 select_scatter, masked_scatter: the update and indices
_HBM_FULL = frozenset((
    "mm", "bmm", "addmm", "baddbmm", "_int_mm", "convolution",
    "convolution_backward", "sum", "mean", "amax", "amin", "max", "min",
    "prod", "var", "std", "var_mean", "norm", "linalg_vector_norm",
    "argmax", "argmin", "all", "any", "cumsum", "cumprod", "logsumexp",
    "_softmax", "_log_softmax", "_softmax_backward_data",
    "_log_softmax_backward_data", "index", "index_select", "gather",
    "embedding", "embedding_dense_backward", "take", "masked_select",
    "scatter", "scatter_add", "scatter_reduce", "index_add", "cat",
    "stack", "constant_pad_nd", "flip", "roll", "repeat", "clone", "sort",
    "topk", "argsort"))
_HBM_UPDATE = frozenset(("copy_", "index_put", "index_put_", "index_copy",
                         "index_copy_", "slice_scatter", "select_scatter",
                         "masked_scatter", "masked_scatter_",
                         "_index_put_impl_"))

_ACTIVE: list = []


def current() -> "OpTrace | None":
    """The innermost active trace, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x, out: list) -> list:
    """Every tensor in an op's argument (tensors, or lists of them)."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            if isinstance(v, torch.Tensor):
                out.append(v)
            elif isinstance(v, (list, tuple)):
                _tensors(v, out)
    return out


def _round(n: int) -> int:
    return -(-n // ALLOC_ROUND) * ALLOC_ROUND


class OpTrace(TorchDispatchMode):
    """Record one rank's program on meta tensors (module docstring).

    ``with OpTrace() as tr: ...`` — then :attr:`flops`, :attr:`bytes`,
    :attr:`hbm`, :attr:`kernels` (``"name"`` and ``"name:mode"`` →
    records), :attr:`kernel_bytes`, :attr:`collectives` (kind → bytes),
    :attr:`collective_counts`, :attr:`ops` (aten ops seen) and
    :meth:`memory`. Register the step's inputs with :meth:`arguments`
    before it runs (a storage first met as an input is counted there as
    well). ``seq_len``: the tokens each decode lane holds at the traced
    step, for the decode kernels' live-token costs (None: every row of
    the capacity)."""

    def __init__(self, seq_len: int | None = None) -> None:
        super().__init__()
        self.seq_len = seq_len
        self.flops = 0           # integer counts: sums stay exact
        self.int8_ops = 0
        self.bytes = 0
        self.hbm = 0
        self.ops = 0
        self.kernels: dict[str, int] = {}
        self.kernel_bytes = 0
        self.collectives = {k: 0 for k in COLLECTIVE_KINDS}
        self.collective_counts = {k: 0 for k in COLLECTIVE_KINDS}
        self._args: dict[int, int] = {}      # storage key → bytes
        self._live: dict[int, int] = {}      # temporaries → rounded bytes
        self._live_bytes = 0
        self._peak = 0
        self._paused = 0

    # ---- the dispatch hook -------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        ins = _tensors(args, [])
        for v in kwargs.values():
            _tensors(v, ins)
        outs = _tensors(out, [])
        for t in ins:
            self._seen_input(t)
        for t in outs:
            self._seen_output(t)
        if self._paused or func.is_view:
            return out
        packet = func.overloadpacket
        name = packet.__name__
        self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        if name in _HBM_FULL:
            self.hbm += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        elif name in _HBM_UPDATE:
            # the update (and indices), never the buffer written into
            self.hbm += sum(map(_nbytes, ins[1:]))
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        return out

    # ---- memory -------------------------------------------------------
    def _key(self, t: torch.Tensor):
        st = t.untyped_storage()
        return st, st._cdata

    def _seen_input(self, t: torch.Tensor) -> None:
        st, key = self._key(t)
        if key not in self._live and key not in self._args:
            # alive before the trace met it: an argument
            self._args[key] = st.nbytes()

    def _seen_output(self, t: torch.Tensor) -> None:
        st, key = self._key(t)
        if key in self._live or key in self._args:
            return
        n = _round(st.nbytes())
        self._live[key] = n
        self._live_bytes += n
        if self._live_bytes > self._peak:
            self._peak = self._live_bytes
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        n = self._live.pop(key, 0)
        self._live_bytes -= n

    def arguments(self, *trees) -> None:
        """Register every tensor of ``trees`` (nested dicts, tuples,
        lists, NamedTuples) as an argument of the traced step."""
        for tree in trees:
            for t in _leaves(tree):
                self._seen_input(t)

    def argument_bytes(self) -> int:
        return sum(self._args.values())

    def memory(self, outputs=None) -> dict:
        """The reference's ``memory_analysis()`` keys. ``outputs``: the
        step's result (a tree); an output that shares an argument's
        storage (a donated buffer updated in place) is aliased.
        ``peak_estimate_bytes`` = the arguments plus the peak of the other
        live bytes = argument + output + temp − alias."""
        arg = self.argument_bytes()
        out_keys = {}
        for t in _leaves(outputs):
            st, key = self._key(t)
            out_keys[key] = st.nbytes()
        alias = sum(n for k, n in out_keys.items() if k in self._args)
        out = sum(out_keys.values())
        temp = self._peak - (out - alias)
        return {"argument_bytes": arg, "output_bytes": out,
                "temp_bytes": temp, "alias_bytes": alias,
                "peak_estimate_bytes": arg + out + temp - alias}

    @property
    def peak_temp_bytes(self) -> int:
        """The peak of live bytes besides the arguments."""
        return self._peak

    # ---- records from the kernel entries and collectives -------------
    @contextmanager
    def paused(self):
        """Ops inside record no cost (their allocations still count):
        a kernel entry's outputs, whose cost is the kernel's record."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def kernel(self, name: str, mode: str | None, cost: dict) -> None:
        """One launch of kernel ``name`` (in ``mode``) costing ``cost``
        (:func:`repro_torch.analysis.roofline.kernel_cost`)."""
        self.kernels[name] = self.kernels.get(name, 0) + 1
        if mode is not None:
            key = f"{name}:{mode}"
            self.kernels[key] = self.kernels.get(key, 0) + 1
        self.flops += cost["int8_ops"] + cost["flops"]
        self.int8_ops += cost["int8_ops"]
        self.bytes += cost["bytes"]
        self.hbm += cost["bytes"]
        self.kernel_bytes += cost["bytes"]

    def snapshot(self) -> dict:
        """The cost counters now (not the memory), for :meth:`since`."""
        return {"flops": self.flops, "int8_ops": self.int8_ops,
                "bytes": self.bytes, "hbm": self.hbm, "ops": self.ops,
                "kernel_bytes": self.kernel_bytes,
                "kernels": dict(self.kernels),
                "collectives": dict(self.collectives),
                "collective_counts": dict(self.collective_counts)}

    def since(self, snap: dict) -> dict:
        """The costs recorded after ``snap`` (a :meth:`snapshot`)."""
        now = self.snapshot()
        out = {k: now[k] - snap[k] for k in ("flops", "int8_ops", "bytes",
                                              "hbm", "ops", "kernel_bytes")}
        for key in ("kernels", "collectives", "collective_counts"):
            out[key] = {k: v - snap[key].get(k, 0)
                        for k, v in now[key].items()
                        if v != snap[key].get(k, 0)}
        return out

    def total(self) -> dict:
        """Every cost recorded so far, in :meth:`since`'s form."""
        return self.since(_ZERO)

    def absorb(self, costs: dict) -> None:
        """Add ``costs`` (a :meth:`since` of this trace or another's) to
        the counters: a program part that repeats one already traced on
        the same shapes, recorded without running it again (its
        allocations are the caller's to make)."""
        for k in ("flops", "int8_ops", "bytes", "hbm", "ops",
                  "kernel_bytes"):
            setattr(self, k, getattr(self, k) + costs[k])
        for key in ("kernels", "collectives", "collective_counts"):
            mine = getattr(self, key)
            for k, v in costs[key].items():
                mine[k] = mine.get(k, 0) + v

    def collective(self, kind: str, nbytes: int) -> None:
        """One collective of ``kind`` whose result is ``nbytes`` on one
        rank."""
        self.collectives[kind] += nbytes
        self.collective_counts[kind] += 1

    # ---- activation ---------------------------------------------------
    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _ACTIVE.remove(self)


_ZERO = {"flops": 0, "int8_ops": 0, "bytes": 0, "hbm": 0, "ops": 0,
         "kernel_bytes": 0, "kernels": {}, "collectives": {},
         "collective_counts": {}}


def _leaves(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return []


def hbm_bytes(trace: OpTrace) -> int:
    """Fused-model HBM bytes of the traced program (one rank): the ops of
    the table above with their operands and result, a partial write's
    update, each kernel record's ``kernel_cost`` bytes; bare elementwise
    ops, views and factories count as fused."""
    return int(trace.hbm)


def collective_bytes(trace: OpTrace) -> dict:
    """→ ``{kind: bytes one rank receives, ..., "total", "counts"}``, the
    reference's dict."""
    out = dict(trace.collectives)
    return {**out, "total": sum(out.values()),
            "counts": dict(trace.collective_counts)}
