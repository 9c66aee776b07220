"""Observability core of the port's serving stack.

A registry of counters / gauges / fixed-bucket histograms with Prometheus
text exposition (format 0.0.4), plus the helpers the rest of the port
shares:

- :func:`percentile` / :func:`summarize` — the one percentile computation
  (numpy's linear interpolation) that ``launch/serve.py`` reports through,
  so a p99 means the same thing in every report.
- :class:`StageTimer` — per-request span recorder for the
  queue → prefill → decode lifecycle the scheduler threads through (one
  timer per request, on the scheduler's ``clock``, so virtual-clock tests
  stay deterministic).

Design constraints, in order:

- stdlib + numpy only (the HTTP front-end grows no dependency);
- instruments are *mergeable*: fixed bucket bounds and monotone counters
  mean two registries combine by addition (:meth:`MetricsRegistry.merge`);
- one place owns the metric NAMES (:func:`scheduler_instruments`,
  :func:`http_instruments`), so the synthetic serve loop and the HTTP server
  export identical series. The names are those of ``repro.serving.metrics``
  (``repro_*``), and :meth:`MetricsRegistry.render` writes the same text
  for the same operations, so a dashboard of the JAX reference and one of
  the port compare line for line.

Nothing here touches a tensor: spans are host clock readings taken where
the scheduler calls the engine. On a card, a span around a call that
returns its logits on the device (a prefill chunk, a verify chunk)
measures the host's time to issue the chunk; one around a call that ends
in a host transfer (a decode or draft step) lasts until the device is
done.

Thread-safety: every mutation takes a per-registry lock. The scheduler
pump thread and the asyncio loop both write; ``/metrics`` renders from
either.
"""

from __future__ import annotations

import re
import threading
import time

import numpy as np

# Prometheus exposition rules: metric names [a-zA-Z_:][a-zA-Z0-9_:]*,
# label names [a-zA-Z_][a-zA-Z0-9_]*
_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# latency buckets (seconds): spans micro-benchmark decode steps (ms) up
# to chunked prefills of long prompts; fixed so histograms merge
DEFAULT_TIME_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                        0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


# ---------------------------------------------------------------------------
# Shared percentile helper
# ---------------------------------------------------------------------------

def percentile(values, q: float) -> float:
    """Linear-interpolation percentile (numpy's default), as one float.

    Empty input yields NaN instead of raising — absent traffic renders
    as a NaN row, not a crashed report. NaN inputs propagate (numpy
    semantics), matching the previous inline copies bit-for-bit.
    """
    arr = np.asarray(list(values), np.float64)
    if arr.size == 0:
        return float("nan")
    return float(np.percentile(arr, q))


def summarize(values, qs=(50, 90, 99), prefix: str = "") -> dict:
    """``{f"{prefix}p{q}": percentile(values, q)}`` over ``qs``."""
    vals = list(values)
    return {f"{prefix}p{q}": percentile(vals, q) for q in qs}


# ---------------------------------------------------------------------------
# Instruments
# ---------------------------------------------------------------------------

class _Child:
    """One labeled series of a family. Subclasses hold the value(s)."""

    def __init__(self, family: "_Family", label_values: tuple):
        self._family = family
        self._lock = family._lock
        self.label_values = label_values


class Counter(_Child):
    def __init__(self, family, label_values):
        super().__init__(family, label_values)
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        assert n >= 0, f"counter {self._family.name} decremented by {n}"
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge(_Child):
    def __init__(self, family, label_values):
        super().__init__(family, label_values)
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        return self._value


class Histogram(_Child):
    """Fixed-bucket histogram: per-bucket counts + sum + count.

    Buckets are upper bounds (``le``); export renders them cumulative
    with a trailing ``+Inf`` per the Prometheus text format.
    """

    def __init__(self, family, label_values):
        super().__init__(family, label_values)
        self.buckets = family.buckets
        self.counts = [0] * (len(self.buckets) + 1)   # last = overflow
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            i = 0
            while i < len(self.buckets) and v > self.buckets[i]:
                i += 1
            self.counts[i] += 1
            self.sum += v
            self.count += 1

    @property
    def value(self) -> float:
        """A histogram's scalar read is its ``_sum`` (matches the
        exported ``<name>_sum`` series)."""
        return self.sum

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile estimate in [0, 1] rank space —
        a cheap server-side p50/p99 for reports; exact percentiles come
        from :func:`percentile` over raw samples."""
        if self.count == 0:
            return float("nan")
        target = q * self.count
        seen = 0
        lo = 0.0
        for i, ub in enumerate(self.buckets):
            nxt = seen + self.counts[i]
            if nxt >= target and self.counts[i]:
                frac = (target - seen) / self.counts[i]
                return lo + frac * (ub - lo)
            seen = nxt
            lo = ub
        return self.buckets[-1] if self.buckets else float("nan")


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """One named metric: fixed kind + label names, N labeled children."""

    def __init__(self, registry, kind: str, name: str, help_: str,
                 label_names: tuple, buckets=None):
        assert _NAME_RE.match(name), f"bad metric name {name!r}"
        assert all(_LABEL_RE.match(l) for l in label_names), label_names
        self.kind = kind
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self.buckets = tuple(buckets) if buckets is not None else ()
        self._lock = registry._lock
        self._children: dict[tuple, _Child] = {}

    def labels(self, **kv) -> _Child:
        assert set(kv) == set(self.label_names), (
            f"{self.name}: labels {sorted(kv)} != declared "
            f"{sorted(self.label_names)}")
        key = tuple(str(kv[l]) for l in self.label_names)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(
                    key, _KINDS[self.kind](self, key))
        return child

    # label-less families proxy the child API on the family itself
    def _default(self) -> _Child:
        assert not self.label_names, (
            f"{self.name} has labels {self.label_names}; call .labels()")
        return self.labels()

    def inc(self, n: float = 1.0) -> None:
        self._default().inc(n)

    def dec(self, n: float = 1.0) -> None:
        self._default().dec(n)

    def set(self, v: float) -> None:
        self._default().set(v)

    def observe(self, v: float) -> None:
        self._default().observe(v)

    @property
    def value(self) -> float:
        return self._default().value


class MetricsRegistry:
    """Mutable collection of metric families, rendered by :meth:`render`.

    Families are created idempotently: asking twice for the same name
    returns the same family (kind/labels must agree). ``REGISTRY`` below
    is the process-wide default the server exports on ``/metrics``;
    tests and the synthetic serve loop build private registries so runs
    don't bleed into each other.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._families: dict[str, _Family] = {}

    def _family(self, kind, name, help_, labels, buckets=None) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                assert fam.kind == kind and \
                    fam.label_names == tuple(labels), (
                    f"{name} re-registered as {kind}{tuple(labels)}, was "
                    f"{fam.kind}{fam.label_names}")
                return fam
            fam = _Family(self, kind, name, help_, tuple(labels), buckets)
            self._families[name] = fam
            return fam

    def counter(self, name, help_="", labels=()) -> _Family:
        return self._family("counter", name, help_, labels)

    def gauge(self, name, help_="", labels=()) -> _Family:
        return self._family("gauge", name, help_, labels)

    def histogram(self, name, help_="", labels=(),
                  buckets=DEFAULT_TIME_BUCKETS) -> _Family:
        return self._family("histogram", name, help_, labels, buckets)

    def value(self, name: str, labels: dict | None = None) -> float:
        """Current value of a counter/gauge series (0.0 if the series
        never fired — a counter that never incremented reads 0)."""
        fam = self._families.get(name)
        if fam is None:
            return 0.0
        key = tuple(str((labels or {})[l]) for l in fam.label_names)
        child = fam._children.get(key)
        return child.value if child is not None else 0.0

    def merge(self, other: "MetricsRegistry") -> None:
        """Fold ``other`` into this registry: counters and histogram
        counts add, gauges take ``other``'s latest value. Bucket bounds
        must agree — that is what "fixed-bucket, mergeable" buys."""
        with self._lock, other._lock:
            for name, ofam in other._families.items():
                fam = self._family(ofam.kind, name, ofam.help,
                                   ofam.label_names, ofam.buckets or None)
                if fam.kind == "histogram":
                    assert fam.buckets == ofam.buckets, (
                        f"{name}: bucket bounds differ — unmergeable")
                for key, ochild in ofam._children.items():
                    kv = dict(zip(fam.label_names, key))
                    child = fam.labels(**kv)
                    if fam.kind == "counter":
                        child._value += ochild._value
                    elif fam.kind == "gauge":
                        child._value = ochild._value
                    else:
                        child.sum += ochild.sum
                        child.count += ochild.count
                        for i, c in enumerate(ochild.counts):
                            child.counts[i] += c

    # ---------------- Prometheus text exposition ----------------

    def render(self) -> str:
        """Prometheus text format 0.0.4: HELP/TYPE per family, one line
        per series; histograms render cumulative ``_bucket`` series plus
        ``_sum``/``_count``."""
        out = []
        with self._lock:
            for name in sorted(self._families):
                fam = self._families[name]
                out.append(f"# HELP {name} {fam.help}")
                out.append(f"# TYPE {name} {fam.kind}")
                for key in sorted(fam._children):
                    child = fam._children[key]
                    base = _labels_str(fam.label_names, key)
                    if fam.kind in ("counter", "gauge"):
                        out.append(f"{name}{base} {_fmt(child.value)}")
                        continue
                    cum = 0
                    for i, ub in enumerate(child.buckets):
                        cum += child.counts[i]
                        le = _labels_str(fam.label_names + ("le",),
                                         key + (_fmt(ub),))
                        out.append(f"{name}_bucket{le} {cum}")
                    cum += child.counts[-1]
                    le = _labels_str(fam.label_names + ("le",),
                                     key + ("+Inf",))
                    out.append(f"{name}_bucket{le} {cum}")
                    out.append(f"{name}_sum{base} {_fmt(child.sum)}")
                    out.append(f"{name}_count{base} {child.count}")
        return "\n".join(out) + "\n"


def _fmt(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _labels_str(names: tuple, values: tuple) -> str:
    if not names:
        return ""
    esc = [str(v).replace("\\", r"\\").replace('"', r'\"')
           .replace("\n", r"\n") for v in values]
    inner = ",".join(f'{n}="{v}"' for n, v in zip(names, esc))
    return "{" + inner + "}"


#: process-wide default registry — the HTTP server exports this on
#: ``/metrics``; library code should take a registry parameter and only
#: default to this.
REGISTRY = MetricsRegistry()


# ---------------------------------------------------------------------------
# Per-request stage timer
# ---------------------------------------------------------------------------

#: lifecycle stages, in order (spec stages only under spec decoding)
STAGES = ("queue", "prefill", "decode")


class StageTimer:
    """Accumulates wall-time per lifecycle stage for ONE request.

    The scheduler drives it: ``enter("queue")`` at submit, ``to()`` on
    each transition, ``finish()`` at retirement — the result is a
    ``{stage: seconds}`` dict whose values sum to the request's
    in-system time. Entering the same stage twice accumulates (chunked
    prefill re-enters "prefill" per chunk if the caller wants per-chunk
    granularity; the scheduler uses one span per stage). ``clock`` is
    injectable so virtual-clock schedulers produce deterministic spans.
    """

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._stage: str | None = None
        self._t0 = 0.0
        self.spans: dict[str, float] = {}

    def enter(self, stage: str) -> None:
        if self._stage is not None:
            self._close()
        self._stage = stage
        self._t0 = self._clock()

    def to(self, stage: str) -> None:
        self.enter(stage)

    def _close(self) -> None:
        dt = self._clock() - self._t0
        self.spans[self._stage] = self.spans.get(self._stage, 0.0) + dt
        self._stage = None

    def finish(self) -> dict[str, float]:
        if self._stage is not None:
            self._close()
        return self.spans


# ---------------------------------------------------------------------------
# The shared metric names (serve loop + HTTP server export these identically)
# ---------------------------------------------------------------------------

class _Namespace:
    def __init__(self, **kv):
        self.__dict__.update(kv)


def scheduler_instruments(registry: MetricsRegistry) -> _Namespace:
    """Bind the scheduler's instrument set on ``registry``.

    One function owns the names so ``launch/serve.py`` and
    ``serving/frontend`` cannot drift apart.
    """
    return _Namespace(
        requests=registry.counter(
            "repro_requests_total",
            "requests retired, by finish reason", labels=("outcome",)),
        shed=registry.counter(
            "repro_requests_shed_total",
            "submits rejected at the admission bound"),
        deadline=registry.counter(
            "repro_deadline_expired_total",
            "requests retired past their deadline_ms budget"),
        fault_events=registry.counter(
            "repro_fault_events_total",
            "non-finite-logit detections (decode guard + spec verify)"),
        fault_recoveries=registry.counter(
            "repro_fault_recoveries_total",
            "rollback+retry recoveries that succeeded"),
        fault_finishes=registry.counter(
            "repro_fault_finishes_total",
            "lanes retired with reason fault (retry also failed)"),
        tokens=registry.counter(
            "repro_tokens_generated_total", "tokens emitted to requests"),
        prefill_tokens=registry.counter(
            "repro_prefill_tokens_total",
            "prompt tokens, by whether they were computed or served "
            "from the prefix store", labels=("source",)),
        queue_depth=registry.gauge(
            "repro_queue_depth", "requests waiting for a lane"),
        active_lanes=registry.gauge(
            "repro_active_lanes", "decode lanes currently occupied"),
        stage_seconds=registry.histogram(
            "repro_request_stage_seconds",
            "per-request wall time by lifecycle stage",
            labels=("stage",)),
        ttft=registry.histogram(
            "repro_request_ttft_seconds",
            "arrival to first emitted token"),
        itl=registry.histogram(
            "repro_request_itl_seconds", "inter-token decode gaps"),
        e2e=registry.histogram(
            "repro_request_e2e_seconds", "arrival to retirement"),
        prefill_chunk=registry.histogram(
            "repro_prefill_chunk_seconds",
            "one engine.prefill_chunk launch"),
        decode_step=registry.histogram(
            "repro_decode_step_seconds",
            "one batched engine.decode_step launch"),
        spec_draft=registry.histogram(
            "repro_spec_draft_seconds",
            "one batched engine.draft launch"),
        spec_verify=registry.histogram(
            "repro_spec_verify_seconds",
            "one engine.verify_chunk launch"),
    )


def http_instruments(registry: MetricsRegistry) -> _Namespace:
    """Bind the HTTP frontend's instrument set on ``registry``."""
    return _Namespace(
        requests=registry.counter(
            "repro_http_requests_total",
            "HTTP requests served, by route and status code",
            labels=("route", "code")),
        in_flight=registry.gauge(
            "repro_http_in_flight", "HTTP requests currently being served"),
        disconnects=registry.counter(
            "repro_http_client_disconnects_total",
            "streaming requests whose client went away mid-stream"),
    )
