"""Continuous-batching scheduler and the lockstep reference path.

A FIFO queue feeds ``n_slots`` persistent decode lanes. Per request:

    admit → chunked prefill → activate → decode → evict

``admit`` reserves a free lane and plans the prompt's chunk grid (chunk =
``lop_block`` tokens; the last chunk is right-padded to the same width
unless that would pass the pool capacity). Each ``step`` first retires
cancelled and deadline-expired requests wherever they are (queued,
mid-prefill, decoding), advances ONE chunk of the oldest mid-prefill lane,
then decodes every active lane by one token under its own
:class:`SamplingParams`. A lane retires on ``eos_id``, a stop sequence or
its token budget.

Fault tolerance: ``max_queue`` bounds the queue (a submit past it is shed
at once, reason ``"shed"``); a lane whose decode logits go non-finite is
rewound bitwise (``engine.rollback``) and retried once through the
engine's single-lane no-LOP step, and gives up with reason ``"fault"``
only if the retry fails too. ``check_invariants=True`` cross-checks the
host bookkeeping against the pool after every step.

:func:`lockstep_generate` is the batch-1 reference: whole-prompt prefill
then one decode step per token, through the same engine and sampler.
Tokens agree with the scheduler's when both use the same ``max_len`` (the
same cache capacity, hence the same LOP budget and prefill operand
shapes): greedy bitwise, sampled same-seed identical.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch.serving.api import (GREEDY, FinishedRequest, GenerateRequest,
                                     PooledEngine, SamplingParams, StepResult)
from repro_torch.serving.cache import pool_capacity


@dataclass
class _Lane:
    req: GenerateRequest
    tokens: list
    remaining: int
    t_admit: float
    t_first: float
    token_times: list


@dataclass
class _Prefill:
    slot: int
    req: GenerateRequest
    chunks: list
    starts: list
    seq_ends: list
    t_admit: float
    next_chunk: int = 0


class Scheduler:
    """Continuous batching over a :class:`PooledEngine`."""

    def __init__(self, engine: PooledEngine, *, n_slots: int,
                 max_queue: int | None = None, check_invariants: bool = False,
                 clock=time.monotonic):
        if not engine.supports_chunked:
            raise NotImplementedError("only chunked prefill is ported")
        self.engine = engine
        self.n_slots = n_slots
        self.max_queue = max_queue
        self.invariant_checks = check_invariants
        self.clock = clock
        self.pool = self.engine.init_pool(n_slots)
        self.capacity = pool_capacity(self.pool)
        self.chunk_tokens = self.engine.chunk_tokens
        self.queue: deque[GenerateRequest] = deque()
        self.lanes: list[_Lane | None] = [None] * n_slots
        self._free: deque[int] = deque(range(n_slots))
        self._prefilling: deque[_Prefill] = deque()
        self._next_tok = np.zeros((n_slots, 1), np.int32)
        self.results: list[FinishedRequest] = []
        self.decode_steps = 0
        self.decode_seconds: list[float] = []
        self.shed_count = 0            # submits rejected at the bound
        self.queue_depth_peak = 0
        self.deadline_count = 0        # requests retired past deadline
        self.fault_events = 0          # non-finite-logit detections
        self.fault_recoveries = 0      # rollback + retry that succeeded
        self.fault_finishes = 0        # lanes retired with reason "fault"
        self.fault_rids: set = set()   # rids a fault recovery touched

    # ---------------- queue ----------------

    def submit(self, req: GenerateRequest) -> bool:
        """Queue ``req``. → False when it was shed at ``max_queue``
        (reject-newest: it finishes at once with reason "shed")."""
        need = len(req.prompt) + req.max_new_tokens
        if need > self.capacity:
            raise ValueError(f"request {req.rid} needs {need} tokens but the "
                             f"pool capacity is {self.capacity}")
        if req.arrival is None:
            req = replace(req, arrival=self.clock())
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            self.shed_count += 1
            self._record_abort(req, reason="shed")
            return False
        self.queue.append(req)
        self.queue_depth_peak = max(self.queue_depth_peak, len(self.queue))
        return True

    @property
    def n_active(self) -> int:
        return sum(lane is not None for lane in self.lanes)

    @property
    def n_prefilling(self) -> int:
        return len(self._prefilling)

    def has_work(self) -> bool:
        return bool(self.queue) or bool(self._prefilling) or self.n_active > 0

    # ---------------- admit / prefill ----------------

    def _plan_chunks(self, req: GenerateRequest):
        """Fixed-width chunk grid of one prompt; the final chunk is padded
        to the same width unless that would pass the pool capacity."""
        plen = len(req.prompt)
        c = self.chunk_tokens
        chunks, starts, seq_ends = [], [], []
        for lo in range(0, max(plen, 1), c):
            hi = min(plen, lo + c)
            width = c if lo + c <= self.capacity else hi - lo
            buf = np.zeros((1, width), np.int32)
            buf[0, :hi - lo] = req.prompt[lo:hi]
            chunks.append(buf)
            starts.append(lo)
            seq_ends.append(hi)
        return chunks, starts, seq_ends

    def admit(self) -> int:
        """Reserve free lanes for queued requests. → number admitted. A
        queued request that was cancelled or expired retires here without
        taking a lane."""
        n = 0
        while self.queue and self._free:
            req = self.queue.popleft()
            reason = self._abort_reason(req)
            if reason:
                if reason == "deadline":
                    self.deadline_count += 1
                self._record_abort(req, reason=reason)
                continue
            slot = self._free.popleft()
            chunks, starts, seq_ends = self._plan_chunks(req)
            self._prefilling.append(_Prefill(slot, req, chunks, starts,
                                             seq_ends, self.clock()))
            n += 1
        return n

    def _start_lane(self, pf: _Prefill, logits, done: list) -> None:
        """Prefill finished: seed the lane with the prompt's sampled first
        token (emission 0 of its key schedule) and write its schedule
        (seed, next step 1) into the pool."""
        sp = pf.req.sampling or GREEDY
        first = self.engine.sample_first(logits, sp)
        self.pool = self.engine.set_sampling_state(self.pool, pf.slot,
                                                   sp.seed, 1)
        now = self.clock()
        lane = _Lane(req=pf.req, tokens=[first],
                     remaining=pf.req.max_new_tokens - 1, t_admit=pf.t_admit,
                     t_first=now, token_times=[now])
        self.lanes[pf.slot] = lane
        self._next_tok[pf.slot, 0] = first
        reason = self._token_reason(lane, first)
        self._emit(lane, first, 0, reason)
        if reason is not None:
            done.append(self._finish(pf.slot, reason))

    def _step_prefill(self, done: list) -> bool:
        if not self._prefilling:
            return False
        pf = self._prefilling[0]
        k = pf.next_chunk
        final = k == len(pf.chunks) - 1
        logits, self.pool = self.engine.prefill_chunk(
            self.pool, pf.slot, pf.chunks[k], pf.starts[k], pf.seq_ends[k],
            final)
        pf.next_chunk += 1
        if final:
            self._prefilling.popleft()
            self._start_lane(pf, logits, done)
        return True

    # ---------------- finish reasons ----------------

    @staticmethod
    def _token_reason(lane: _Lane, tok: int) -> str | None:
        """Finish reason after appending ``tok``, or None to continue.
        Precedence: eos > stop sequence > token budget."""
        req = lane.req
        if req.eos_id is not None and tok == req.eos_id:
            return "eos"
        for seq in req.stop:
            if len(seq) <= len(lane.tokens) \
                    and tuple(lane.tokens[-len(seq):]) == seq:
                return "stop"
        if lane.remaining <= 0:
            return "length"
        return None

    @staticmethod
    def _emit(lane: _Lane, tok: int, index: int, reason: str | None) -> None:
        """Stream one token to the request's ``on_token`` callback."""
        cb = lane.req.on_token
        if cb is not None:
            cb(StepResult(rid=lane.req.rid, token=tok, index=index,
                          finished=reason is not None,
                          finish_reason=reason or ""))

    def _expired(self, req: GenerateRequest) -> bool:
        """Whether ``req``'s ``deadline_ms`` (from arrival) has run out."""
        if req.deadline_ms is None or req.arrival is None:
            return False
        return (self.clock() - req.arrival) * 1e3 > req.deadline_ms

    def _abort_reason(self, req: GenerateRequest) -> str | None:
        """Terminal reason forcing ``req`` out mid-flight, or None;
        cancellation wins over the deadline."""
        if req.cancelled:
            return "cancelled"
        if self._expired(req):
            return "deadline"
        return None

    def _sweep_terminal(self, done: list) -> None:
        """Retire cancelled and expired requests wherever they are: queued,
        mid-prefill (the reserved lane is released between chunks), or
        decoding. Runs at the top of every serve cycle."""
        if any(self._abort_reason(r) for r in self.queue):
            kept: deque[GenerateRequest] = deque()
            for req in self.queue:
                reason = self._abort_reason(req)
                if reason:
                    if reason == "deadline":
                        self.deadline_count += 1
                    done.append(self._record_abort(req, reason=reason))
                else:
                    kept.append(req)
            self.queue = kept
        if any(self._abort_reason(p.req) for p in self._prefilling):
            kept_p: deque[_Prefill] = deque()
            for pf in self._prefilling:
                reason = self._abort_reason(pf.req)
                if reason:
                    if reason == "deadline":
                        self.deadline_count += 1
                    done.append(self._record_abort(
                        pf.req, t_admit=pf.t_admit, reason=reason))
                    self._free.append(pf.slot)
                else:
                    kept_p.append(pf)
            self._prefilling = kept_p
        for slot, lane in enumerate(self.lanes):
            if lane is not None:
                reason = self._abort_reason(lane.req)
                if reason:
                    if reason == "deadline":
                        self.deadline_count += 1
                    done.append(self._finish(slot, reason))

    # ---------------- decode ----------------

    def _append_token(self, slot: int, tok: int, done: list) -> None:
        """Commit one emitted token to lane ``slot``: record it, stream it,
        and retire the lane if it hit a finish reason."""
        lane = self.lanes[slot]
        idx = len(lane.tokens)
        lane.tokens.append(tok)
        lane.token_times.append(self.clock())
        lane.remaining -= 1
        self._next_tok[slot, 0] = tok
        reason = self._token_reason(lane, tok)
        self._emit(lane, tok, idx, reason)
        if reason is not None:
            done.append(self._finish(slot, reason))

    def _recover_lane(self, slot: int, temps, tks, tps, done: list) -> None:
        """Non-finite logits on lane ``slot`` this step: rewind the poisoned
        append bitwise (K/V, scales, LOP features, key step), recompute
        the token once through the engine's single-lane no-LOP retry, and
        retire the lane with reason "fault" only if that fails too."""
        lane = self.lanes[slot]
        self.fault_events += 1
        self.fault_rids.add(lane.req.rid)
        self.pool = self.engine.rollback(self.pool, slot, 1)
        toks, ok, self.pool = self.engine.retry_step(
            self.pool, slot, self._next_tok, temps, tks, tps)
        if not bool(ok[slot]):
            self.pool = self.engine.rollback(self.pool, slot, 1)
            self.fault_finishes += 1
            done.append(self._finish(slot, "fault"))
            return
        self.fault_recoveries += 1
        self._append_token(slot, int(toks[slot]), done)

    def step(self) -> list[FinishedRequest]:
        """One serve cycle: terminal sweep (cancellations and deadlines),
        ≤ 1 prefill chunk, then one decode step over every active lane.
        → the requests that finished."""
        done = self._step_inner()
        if self.invariant_checks:
            self.check_invariants()
        return done

    def _step_inner(self) -> list[FinishedRequest]:
        done: list[FinishedRequest] = []
        self._sweep_terminal(done)
        self._step_prefill(done)
        if self.n_active == 0:
            return done
        temps = np.zeros(self.n_slots, np.float32)
        tks = np.zeros(self.n_slots, np.int32)
        tps = np.ones(self.n_slots, np.float32)
        for slot, lane in enumerate(self.lanes):
            if lane is not None:
                sp = lane.req.sampling or GREEDY
                temps[slot], tks[slot], tps[slot] = (sp.temperature,
                                                     sp.top_k, sp.top_p)
        t0 = time.perf_counter()
        toks, self.pool = self.engine.decode_step(self.pool, self._next_tok,
                                                  temps, tks, tps)
        self.decode_seconds.append(time.perf_counter() - t0)
        self.decode_steps += 1
        ok = self.engine.last_ok
        for slot, lane in enumerate(self.lanes):
            if lane is None:
                continue
            if not ok[slot]:
                self._recover_lane(slot, temps, tks, tps, done)
            else:
                self._append_token(slot, int(toks[slot]), done)
        return done

    def _finish(self, slot: int, reason: str) -> FinishedRequest:
        lane = self.lanes[slot]
        res = FinishedRequest(
            rid=lane.req.rid, prompt_len=len(lane.req.prompt),
            tokens=lane.tokens, finish_reason=reason,
            t_arrival=lane.req.arrival, t_admit=lane.t_admit,
            t_first=lane.t_first, t_done=self.clock(),
            token_times=lane.token_times)
        self.pool = self.engine.evict(self.pool, slot)
        self.lanes[slot] = None
        self._free.append(slot)
        self._next_tok[slot, 0] = 0
        self.results.append(res)
        return res

    def _record_abort(self, req: GenerateRequest, t_admit: float = 0.0,
                      reason: str = "cancelled") -> FinishedRequest:
        """A request retired before emitting any token (cancelled,
        deadline-expired or shed)."""
        now = self.clock()
        res = FinishedRequest(
            rid=req.rid, prompt_len=len(req.prompt), tokens=[],
            finish_reason=reason,
            t_arrival=req.arrival if req.arrival is not None else now,
            t_admit=t_admit or now, t_first=now, t_done=now, token_times=[])
        self.results.append(res)
        return res

    # ---------------- invariants ----------------

    def check_invariants(self) -> None:
        """Cross-check host bookkeeping against the pool; raises
        AssertionError on a broken contract.

        - every slot is exactly one of occupied, reserved (mid-prefill) or
          free;
        - the pool's ``active`` mask equals the occupied set;
        - lengths stay within capacity, and an occupied lane's length is
          its prompt plus its emissions minus the one pending token;
        - a sampled lane's ``sample_step`` equals its emission count (so
          rollback and retry net to exactly the tokens delivered).
        """
        occupied = {s for s, lane in enumerate(self.lanes) if lane is not None}
        reserved = {pf.slot for pf in self._prefilling}
        free = set(self._free)
        if not (occupied.isdisjoint(reserved) and occupied.isdisjoint(free)
                and reserved.isdisjoint(free)):
            raise AssertionError(f"slot sets overlap: occupied={occupied} "
                                 f"reserved={reserved} free={free}")
        if len(free) != len(self._free):
            raise AssertionError("duplicate slots in the free list")
        if occupied | reserved | free != set(range(self.n_slots)):
            raise AssertionError(f"slot partition incomplete: occupied="
                                 f"{occupied} reserved={reserved} free={free}")
        active = {int(s) for s in
                  np.flatnonzero(self.pool["active"].cpu().numpy())}
        if active != occupied:
            raise AssertionError(f"pool active mask {active} != occupied "
                                 f"lanes {occupied}")
        lengths = self.pool["lengths"].cpu().numpy()
        steps = self.pool["sample_step"].cpu().numpy()
        if int(lengths.max(initial=0)) > self.capacity:
            raise AssertionError(f"lane length {int(lengths.max())} exceeds "
                                 f"capacity {self.capacity}")
        if int(steps.min(initial=0)) < 0:
            raise AssertionError(f"negative sample_step: {steps}")
        for slot in occupied:
            lane = self.lanes[slot]
            want = len(lane.req.prompt) + len(lane.tokens) - 1
            if int(lengths[slot]) != want:
                raise AssertionError(f"slot {slot}: length "
                                     f"{int(lengths[slot])} != {want}")
            sp = lane.req.sampling
            if sp is not None and not sp.greedy \
                    and int(steps[slot]) != len(lane.tokens):
                raise AssertionError(
                    f"slot {slot}: sample_step {int(steps[slot])} != "
                    f"emissions {len(lane.tokens)}")

    def run_to_completion(self) -> list[FinishedRequest]:
        """Drain the queue and every lane (all requests already submitted)."""
        while self.has_work():
            self.admit()
            self.step()
        return self.results


def lockstep_generate(eng: PooledEngine, prompt, max_new_tokens: int, *,
                      eos_id: int | None = None,
                      sampling: SamplingParams | None = None, stop=(),
                      on_token=None, cancel=None) -> list:
    """Batch-1 reference: whole-prompt prefill, then one decode step per
    token, through the same engine and sampler as a :class:`Scheduler` on
    it (so the same ``max_len``, cache capacity, LOP budget and key
    schedule). Honors eos, stop sequences, ``on_token`` and ``cancel``."""
    sp = sampling or GREEDY
    req = GenerateRequest(rid=-1, prompt=np.asarray(prompt, np.int32),
                          max_new_tokens=max_new_tokens, eos_id=eos_id,
                          sampling=sp, stop=stop, on_token=on_token,
                          cancel=cancel)
    logits, cache = eng.prefill(req.prompt[None])
    # the batch-1 cache carries the pool's key-schedule leaves: seed and
    # next step 1 (step 0 is the prefill's first-token draw)
    for key in ("seed", "sample_step"):
        cache[key] = torch.zeros(1, dtype=torch.int32, device=eng.device)
    cache = eng.set_sampling_state(cache, 0, sp.seed, 1)
    toks: list = []

    def append(tok: int) -> str | None:
        toks.append(tok)
        lane = _Lane(req=req, tokens=toks,
                     remaining=max_new_tokens - len(toks), t_admit=0.0,
                     t_first=0.0, token_times=[])
        reason = Scheduler._token_reason(lane, tok)
        Scheduler._emit(lane, tok, len(toks) - 1, reason)
        return reason

    reason = append(eng.sample_first(logits, sp))
    temps, tks, tps = ([sp.temperature], [sp.top_k], [sp.top_p])
    while reason is None and not req.cancelled:
        nxt, cache = eng.decode_step(
            cache, np.asarray([[toks[-1]]], np.int32), temps, tks, tps)
        reason = append(int(nxt[0]))
    return toks
