"""Continuous-batching scheduler and the lockstep reference path.

A FIFO queue feeds ``n_slots`` persistent decode lanes. Per request:

    admit → chunked prefill → activate → decode → evict

``admit`` reserves a free lane and plans the prompt's chunk grid (chunk =
``lop_block`` tokens; the last chunk is right-padded to the same width
unless that would pass the pool capacity). Each ``step`` advances ONE
chunk of the oldest mid-prefill lane, then decodes every active lane by
one greedy token. A lane retires on ``eos_id`` or its token budget.

:func:`lockstep_generate` is the batch-1 reference: whole-prompt prefill
then one decode step per token, through the same engine. Greedy tokens
agree with the scheduler's when both use the same ``max_len`` (the same
cache capacity, hence the same LOP budget and prefill operand shapes).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, replace

import numpy as np

from repro_torch.serving.api import (FinishedRequest, GenerateRequest,
                                     PooledEngine)
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
                 clock=time.monotonic):
        if not engine.supports_chunked:
            raise NotImplementedError("only chunked prefill is ported")
        self.engine = engine
        self.n_slots = n_slots
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

    def submit(self, req: GenerateRequest) -> None:
        need = len(req.prompt) + req.max_new_tokens
        if need > self.capacity:
            raise ValueError(f"request {req.rid} needs {need} tokens but the "
                             f"pool capacity is {self.capacity}")
        if req.arrival is None:
            req = replace(req, arrival=self.clock())
        self.queue.append(req)

    @property
    def n_active(self) -> int:
        return sum(lane is not None for lane in self.lanes)

    @property
    def n_prefilling(self) -> int:
        return len(self._prefilling)

    def has_work(self) -> bool:
        return bool(self.queue) or bool(self._prefilling) or self.n_active > 0

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
        """Reserve free lanes for queued requests. → number admitted."""
        n = 0
        while self.queue and self._free:
            req = self.queue.popleft()
            slot = self._free.popleft()
            chunks, starts, seq_ends = self._plan_chunks(req)
            self._prefilling.append(_Prefill(slot, req, chunks, starts,
                                             seq_ends, self.clock()))
            n += 1
        return n

    def _start_lane(self, pf: _Prefill, logits, done: list) -> None:
        first = self.engine.sample_first(logits)
        now = self.clock()
        lane = _Lane(req=pf.req, tokens=[first],
                     remaining=pf.req.max_new_tokens - 1, t_admit=pf.t_admit,
                     t_first=now, token_times=[now])
        self.lanes[pf.slot] = lane
        self._next_tok[pf.slot, 0] = first
        reason = self._token_reason(lane, first)
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

    @staticmethod
    def _token_reason(lane: _Lane, tok: int) -> str | None:
        if lane.req.eos_id is not None and tok == lane.req.eos_id:
            return "eos"
        if lane.remaining <= 0:
            return "length"
        return None

    def step(self) -> list[FinishedRequest]:
        """≤ 1 prefill chunk, then one greedy decode step over every
        active lane. → the requests that finished."""
        done: list[FinishedRequest] = []
        self._step_prefill(done)
        if self.n_active == 0:
            return done
        t0 = time.perf_counter()
        toks, self.pool = self.engine.decode_step(self.pool, self._next_tok)
        self.decode_seconds.append(time.perf_counter() - t0)
        self.decode_steps += 1
        for slot, lane in enumerate(self.lanes):
            if lane is None:
                continue
            tok = int(toks[slot])
            lane.tokens.append(tok)
            lane.token_times.append(self.clock())
            lane.remaining -= 1
            self._next_tok[slot, 0] = tok
            reason = self._token_reason(lane, tok)
            if reason is not None:
                done.append(self._finish(slot, reason))
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

    def run_to_completion(self) -> list[FinishedRequest]:
        """Drain the queue and every lane (all requests already submitted)."""
        while self.has_work():
            self.admit()
            self.step()
        return self.results


def lockstep_generate(eng: PooledEngine, prompt, max_new_tokens: int, *,
                      eos_id: int | None = None) -> list:
    """Batch-1 reference: whole-prompt prefill, then one decode step per
    token, greedy, through the same engine (so the same ``max_len``, cache
    capacity and LOP budget as a :class:`Scheduler` on it)."""
    prompt = np.asarray(prompt, np.int32)
    logits, cache = eng.prefill(prompt[None])
    toks = [eng.sample_first(logits)]
    while len(toks) < max_new_tokens and toks[-1] != eos_id:
        nxt, cache = eng.decode_step(cache, np.asarray([[toks[-1]]],
                                                       np.int32))
        toks.append(int(nxt[0]))
    return toks
