"""Deterministic fault injection for the serving stack.

A frozen, seeded :class:`FaultPlan` names which engine call and lane
misbehaves, and :func:`inject` activates it for a scoped region of code.
Injection is keyed by call counters (the N-th ``decode_step`` dispatch,
the N-th prefix-store insert, the N-th store lookup), not wall time, so
two runs of one request trace under one plan inject at the same points.
The detection and recovery it exercises live in the scheduler (NaN guard
→ ``rollback_slot`` → no-LOP retry; a lookup outage → cold prefill) and
in :class:`repro_torch.serving.cache.PrefixStore` (page checksums → a
shorter match or a cold prefill).

The plan is the reference's whole (``FaultPlan.random`` draws the same
plan for the same seed), and a flipped page bit is drawn from the same
seeded generator in the same order, so it lands on the reference's leaf,
byte and bit.

No plan active (the default) costs one ``is None`` check per injection
point.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np


class PrefixLookupError(RuntimeError):
    """An injected prefix-store lookup failure (a store outage). The
    scheduler degrades the request to a cold prefill and counts it."""


@dataclass(frozen=True)
class FaultPlan:
    """One deterministic failure schedule.

    ``nan_logits``       {(decode_call, lane)}: that lane's decode logits
                         go non-finite on that dispatch (transient — the
                         no-LOP retry recomputes it cleanly).
    ``sticky_nan_lanes`` {lane}: non-finite on EVERY dispatch including
                         the retry, so the lane finishes with ``"fault"``.
    ``page_bitflips``    {insert_call}: the prefix-store node interned by
                         that ``PrefixStore.insert`` call gets one bit
                         flipped in its pages after its checksum is taken
                         (the next match's checksum catches it).
    ``lookup_failures``  {match_call}: that ``PrefixStore.match`` call
                         raises :class:`PrefixLookupError`.
    ``slow_steps``       {decode_call}: that dispatch sleeps ``slow_s``
                         seconds first (deadline pressure).
    """
    seed: int = 0
    nan_logits: frozenset = frozenset()
    sticky_nan_lanes: frozenset = frozenset()
    page_bitflips: frozenset = frozenset()
    lookup_failures: frozenset = frozenset()
    slow_steps: frozenset = frozenset()
    slow_s: float = 0.0

    @staticmethod
    def random(seed: int, *, n_decode_calls: int, n_lanes: int,
               nan_events: int = 2, sticky_lanes: int = 0,
               page_flips: int = 1, lookup_fails: int = 1,
               slow_steps: int = 0, slow_s: float = 0.0) -> "FaultPlan":
        """A seeded random plan over ``n_decode_calls`` batched decode
        dispatches — same seed, same plan, the reference's draws in the
        reference's order."""
        rng = np.random.default_rng(seed)

        def pick(n, hi):
            n = min(n, hi)
            return frozenset(int(x) for x in
                             rng.choice(hi, size=n, replace=False)) \
                if n > 0 and hi > 0 else frozenset()

        nan = frozenset(
            (int(c), int(rng.integers(0, n_lanes)))
            for c in rng.choice(max(1, n_decode_calls),
                                size=min(nan_events, n_decode_calls),
                                replace=False)) if nan_events else frozenset()
        return FaultPlan(
            seed=seed, nan_logits=nan,
            sticky_nan_lanes=pick(sticky_lanes, n_lanes),
            page_bitflips=pick(page_flips, 8),
            lookup_failures=pick(lookup_fails, 16),
            slow_steps=pick(slow_steps, max(1, n_decode_calls)),
            slow_s=slow_s)


@dataclass
class _FaultState:
    """Mutable per-``inject`` bookkeeping: call counters + telemetry."""
    plan: FaultPlan
    decode_calls: int = 0
    insert_calls: int = 0
    match_calls: int = 0
    injected_nan: int = 0
    injected_slow: int = 0
    injected_flips: int = 0
    injected_lookup_failures: int = 0


_STATE: _FaultState | None = None


def active() -> FaultPlan | None:
    """The plan in scope, or None (the production fast path)."""
    return _STATE.plan if _STATE is not None else None


def state() -> _FaultState | None:
    """Injection telemetry for the current scope."""
    return _STATE


@contextmanager
def inject(plan: FaultPlan):
    """Activate ``plan`` for the enclosed serve trace. Nesting raises:
    nested plans would make the call counters ambiguous."""
    global _STATE
    if _STATE is not None:
        raise RuntimeError("fault plans do not nest")
    _STATE = _FaultState(plan)
    try:
        yield _STATE
    finally:
        _STATE = None


def decode_fault_add(n_lanes: int):
    """Per-lane logit offset (np.float32 [n_lanes]) for the NEXT batched
    decode dispatch, or None when no plan is active. Advances the
    decode-call counter and sleeps the planned slow-step delay. NaN
    entries mark the injected faults."""
    st = _STATE
    if st is None:
        return None
    call = st.decode_calls
    st.decode_calls += 1
    if call in st.plan.slow_steps and st.plan.slow_s > 0:
        st.injected_slow += 1
        time.sleep(st.plan.slow_s)
    add = np.zeros((n_lanes,), np.float32)
    for lane in st.plan.sticky_nan_lanes:
        if lane < n_lanes:
            add[lane] = np.nan
            st.injected_nan += 1
    for (c, lane) in st.plan.nan_logits:
        if c == call and lane < n_lanes:
            add[lane] = np.nan
            st.injected_nan += 1
    return add


def retry_fault_add(n_lanes: int):
    """Logit offset for a recovery retry: only sticky lanes stay faulted
    (transient events never re-fire). Does not advance the counter."""
    st = _STATE
    if st is None or not st.plan.sticky_nan_lanes:
        return None
    add = np.zeros((n_lanes,), np.float32)
    for lane in st.plan.sticky_nan_lanes:
        if lane < n_lanes:
            add[lane] = np.nan
    return add


def page_corruption_rng():
    """For the NEXT ``PrefixStore.insert`` call: a seeded Generator to
    pick the flipped bit with, or None. Advances the insert counter."""
    st = _STATE
    if st is None:
        return None
    call = st.insert_calls
    st.insert_calls += 1
    if call not in st.plan.page_bitflips:
        return None
    st.injected_flips += 1
    return np.random.default_rng((st.plan.seed, call))


def lookup_fails() -> bool:
    """Whether the NEXT ``PrefixStore.match`` call raises
    :class:`PrefixLookupError`. Advances the match counter."""
    st = _STATE
    if st is None:
        return False
    call = st.match_calls
    st.match_calls += 1
    if call in st.plan.lookup_failures:
        st.injected_lookup_failures += 1
        return True
    return False
