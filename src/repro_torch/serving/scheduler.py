"""Continuous-batching scheduler and the lockstep reference path.

A FIFO queue feeds ``n_slots`` persistent decode lanes. Per request:

    admit → chunked prefill → activate → decode → evict

or, on an engine that does not declare ``supports_chunked`` (moe, whose
routers rank a group's tokens for expert capacity; encdec; the recurrent
ssm and hybrid families, whose state integrates every position), the
run-to-completion regime: ``admit`` prefills the whole prompt at once, batch 1 and at its
exact length (``engine.prefill`` → ``engine.insert``), and the lane
decodes from the next step; a prefill that runs while other lanes are
decoding stalls them and counts in ``full_prefill_stalls``. The prefix
store is off there (prefix pages resume through the chunk carry).

A vlm request's image prefix (``patches``, :meth:`PooledEngine.prefix_len`
positions) rides its first chunk, or its whole prefill, and shifts every
later chunk past it; a lane's length counts it. Image requests never
match or intern prefix pages: their pages depend on the image, which the
store's token keys do not see.

In the chunked regime ``admit`` reserves a free lane and plans the
prompt's chunk grid (chunk = ``lop_block`` tokens; the last chunk is
right-padded to the same width unless that would pass the pool
capacity). With the prefix cache on (the default) the prompt is first
matched against the
:class:`repro_torch.serving.cache.PrefixStore`: hits are cloned into their
lanes after the admit sweep — node by node, one ``engine.bulk_insert`` a
chain node for all the lanes that matched it — and plan chunks for the
uncached suffix only; a finished prompt's block-aligned pages are interned
at activation. Each ``step`` first
retires cancelled and deadline-expired requests wherever they are (queued,
mid-prefill, decoding), advances ONE chunk of the oldest mid-prefill lane,
then decodes every active lane by one token under its own
:class:`SamplingParams` — or, with ``spec_decode``, runs one speculative
round (γ batched draft steps, then one γ+1-row verify chunk a lane; the
agreeing drafts and the verifier's next token are emitted, the rejected
tail rewound). A lane retires on ``eos_id``, a stop sequence or its token
budget.

Fault tolerance: ``max_queue`` bounds the queue (a submit past it is shed
at once, reason ``"shed"``); a lane whose decode logits go non-finite is
rewound bitwise (``engine.rollback``) and retried once through the
engine's single-lane no-LOP step, and gives up with reason ``"fault"``
only if the retry fails too (a faulted lane drafts no more); a store
outage degrades to a cold prefill and a corrupt interned page to a shorter
match; a lane whose drafts are never accepted stops drafting after
``spec_watchdog`` rounds. ``check_invariants=True`` cross-checks the host
bookkeeping against the pool (and the store's structure) after every
step.

Metrics: the scheduler publishes the reference's series
(:func:`repro_torch.serving.metrics.scheduler_instruments`) at the
reference's call sites onto ``metrics`` (the process-wide ``REGISTRY``
unless a registry is passed): outcomes, shed, deadline and fault counters,
tokens, prefill tokens by source, queue depth, active lanes, TTFT, ITL,
end-to-end latency, each request's queue / prefill / decode spans (a
:class:`~repro_torch.serving.metrics.StageTimer` on ``clock``), and one
span for each engine call: ``prefill_chunk``, ``decode_step``, ``draft``
and ``verify_chunk``. No span waits on the device.

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

from repro_torch.serving import cache as _cache
from repro_torch.serving import metrics as _metrics
from repro_torch.serving.api import (GREEDY, ExistingPrefix, FinishedRequest,
                                     GenerateRequest, PooledEngine,
                                     SamplingParams, StepResult)
from repro_torch.serving.cache import PrefixStore, pool_capacity
from repro_torch.serving.faults import PrefixLookupError


@dataclass
class _Lane:
    req: GenerateRequest
    tokens: list
    remaining: int
    t_admit: float
    t_first: float
    token_times: list
    cached_len: int = 0                # prompt tokens cloned from the store
    no_spec: bool = False              # drafting off (watchdog or fault)
    zero_accept_rounds: int = 0        # consecutive 0-accept spec rounds


@dataclass
class _Prefill:
    slot: int
    req: GenerateRequest
    chunks: list
    starts: list
    seq_ends: list
    t_admit: float
    next_chunk: int = 0
    cached_len: int = 0                # prefix tokens the lane resumes past


class Scheduler:
    """Continuous batching over a :class:`PooledEngine`.

    ``prefix_cache`` (on by default) caches prefixes wherever the engine
    declares a ``prefix_block`` and the prompts are chunked; the interned
    pages are bounded at 4× the pool's token capacity. ``chunked=False``
    prefills every prompt whole, as an engine without ``supports_chunked``
    does. ``spec_decode`` turns on self-speculative
    decoding with draft length ``gamma`` where the engine declares
    ``supports_speculative``; ``spec_watchdog`` is the number of
    consecutive zero-accept rounds after which a lane drafts no more.
    ``metrics`` is the registry the scheduler publishes onto.
    """

    def __init__(self, engine: PooledEngine, *, n_slots: int,
                 max_queue: int | None = None, check_invariants: bool = False,
                 chunked: bool = True, prefix_cache: bool = True,
                 spec_decode: bool = False, gamma: int = 4,
                 spec_watchdog: int = 3, clock=time.monotonic, metrics=None):
        if spec_decode and gamma < 1:
            raise ValueError(f"spec_decode needs gamma >= 1, got {gamma}")
        self.engine = engine
        self.cfg = engine.cfg
        self.n_slots = n_slots
        self.max_queue = max_queue
        self.invariant_checks = check_invariants
        self.clock = clock
        self.pool = self.engine.init_pool(n_slots)
        self.capacity = pool_capacity(self.pool)
        # encdec lanes hold the encoder memory in pages of their own
        self.cross_capacity = _cache.pool_cross_capacity(self.pool)
        self.chunk_tokens = self.engine.chunk_tokens
        self.chunked = chunked and self.engine.supports_chunked
        # an engine without rewindable pages or a chunked verify serves
        # plain decode
        self.spec = spec_decode and self.engine.supports_speculative
        self.gamma = gamma
        self.spec_watchdog = spec_watchdog
        self.prefix_store: PrefixStore | None = None
        if prefix_cache and self.chunked and self.engine.prefix_block:
            self.prefix_store = PrefixStore(self.engine.prefix_block,
                                            max_tokens=4 * self.capacity)
        self.queue: deque[GenerateRequest] = deque()
        self.lanes: list[_Lane | None] = [None] * n_slots
        self._free: deque[int] = deque(range(n_slots))
        self._prefilling: deque[_Prefill] = deque()
        self._next_tok = np.zeros((n_slots, 1), np.int32)
        self.results: list[FinishedRequest] = []
        # every sample of the decode_step and spec_draft series (each step
        # ends in its one host transfer), and each verify chunk's seconds
        # through the host's read of its finiteness
        self.decode_seconds: list[float] = []
        self.draft_seconds: list[float] = []
        self.verify_seconds: list[float] = []
        # prefix-cache telemetry: hits, and prompt tokens served from
        # interned pages against those actually computed
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self.prefill_tokens_computed = 0
        self.prefill_tokens_served = 0
        # whole-prompt prefills (run-to-completion regime) that ran while
        # other lanes were decoding, and each one's host seconds
        self.full_prefill_stalls = 0
        self.full_prefill_seconds: list[float] = []
        # speculative telemetry: full-model launches are decode_launches
        # + spec_verify_launches; draft_launches are the proposer's steps
        self.spec_rounds = 0
        self.spec_drafted = 0          # draft tokens proposed
        self.spec_accepted = 0         # drafts that matched verify
        self.spec_emitted = 0          # tokens emitted by spec rounds
        self.spec_verify_launches = 0
        self.draft_launches = 0
        self.decode_launches = 0       # plain decode steps
        self.prefix_lookup_failures = 0
        self.spec_watchdog_trips = 0
        self.shed_count = 0            # submits rejected at the bound
        self.queue_depth_peak = 0
        self.deadline_count = 0        # requests retired past deadline
        self.fault_events = 0          # non-finite-logit detections
        self.fault_recoveries = 0      # rollback + retry that succeeded
        self.fault_finishes = 0        # lanes retired with reason "fault"
        self.fault_rids: set = set()   # rids a fault recovery touched
        self.metrics = metrics if metrics is not None else _metrics.REGISTRY
        self._m = _metrics.scheduler_instruments(self.metrics)
        self._timers: dict = {}        # rid -> StageTimer, until retirement

    # ---------------- queue ----------------

    def submit(self, req: GenerateRequest) -> bool:
        """Queue ``req``. → False when it was shed at ``max_queue``
        (reject-newest: it finishes at once with reason "shed")."""
        need = (self.engine.prefix_len(req) + len(req.prompt)
                + req.max_new_tokens)
        # an attention-free pool (capacity 0: recurrent state only) has no
        # token bound
        if self.capacity and need > self.capacity:
            raise ValueError(f"request {req.rid} needs {need} tokens but the "
                             f"pool capacity is {self.capacity}")
        if (req.frames is not None) != bool(self.cross_capacity):
            raise ValueError(
                f"request {req.rid}: an encdec engine needs frames and "
                f"any other takes none")
        if req.patches is not None and not self.engine.has_image_prefix:
            raise ValueError(f"request {req.rid}: only a vlm engine takes "
                             f"patches")
        if req.frames is not None and len(req.frames) > self.cross_capacity:
            raise ValueError(f"request {req.rid} has {len(req.frames)} "
                             f"encoder frames but the pool's cross capacity "
                             f"is {self.cross_capacity}")
        if req.sampling is not None and req.sampling.gamma < 0:
            raise ValueError(f"request {req.rid}: sampling.gamma must be "
                             f">= 0 (0 = the scheduler's), got "
                             f"{req.sampling.gamma}")
        if req.arrival is None:
            req = replace(req, arrival=self.clock())
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            self.shed_count += 1
            self._m.shed.inc()
            self._record_abort(req, reason="shed")
            return False
        timer = _metrics.StageTimer(self.clock)
        timer.enter("queue")
        self._timers[req.rid] = timer
        self.queue.append(req)
        self.queue_depth_peak = max(self.queue_depth_peak, len(self.queue))
        self._m.queue_depth.set(len(self.queue))
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

    def _plan_chunks(self, req: GenerateRequest, skip: int = 0):
        """Fixed-width chunk grid of one prompt's suffix ``[skip, plen)``
        (``skip``: block-aligned tokens a prefix hit already holds, so the
        first chunk starts at the cached boundary); the final chunk is
        padded to the same width unless that would pass the pool
        capacity. A vlm request's image prefix rides the first chunk
        (start 0; its patches go in at :meth:`_step_prefill`), and every
        later position is shifted past it."""
        plen = len(req.prompt)
        prefix = self.engine.prefix_len(req)
        c = self.chunk_tokens
        chunks, starts, seq_ends = [], [], []
        for lo in range(skip, max(plen, skip + 1), c):
            hi = min(plen, lo + c)
            width = c if prefix + lo + c <= self.capacity else hi - lo
            buf = np.zeros((1, width), np.int32)
            buf[0, :hi - lo] = req.prompt[lo:hi]
            chunks.append(buf)
            starts.append(prefix + lo if lo else 0)
            seq_ends.append(prefix + hi)
        return chunks, starts, seq_ends

    def _match(self, req: GenerateRequest):
        """The prompt's longest interned prefix → (tokens, node); a store
        outage is a miss, counted."""
        if self.prefix_store is None or self.engine.prefix_len(req):
            return 0, None
        try:
            return self.prefix_store.match(req.prompt)
        except PrefixLookupError:
            self.prefix_lookup_failures += 1
            return 0, None

    def admit(self) -> int:
        """Fill free lanes from the queue. → number admitted. A queued
        request that was cancelled or expired retires here without taking
        a lane. Chunked regime: the lane is reserved and the prompt's chunk
        grid planned; prefix hits plan their uncached suffix only, and
        their pages are cloned after the sweep: for each matched node,
        every lane that hit it takes the chain node by node (one
        ``bulk_insert`` a chain node, at its own token offset).
        Run-to-completion regime: the whole prompt prefills here and the
        lane activates at once (a request that finishes on its first token
        is in ``results``)."""
        n = 0
        clones: dict = {}          # prefix node key -> (node, [slots])
        while self.queue and self._free:
            req = self.queue.popleft()
            reason = self._abort_reason(req)
            if reason:
                if reason == "deadline":
                    self.deadline_count += 1
                self._record_abort(req, reason=reason)
                continue
            slot = self._free.popleft()
            timer = self._timers.get(req.rid)
            if timer is not None:
                timer.to("prefill")
            if not self.chunked:
                self._prefill_whole(slot, req)
                n += 1
                continue
            skip, node = self._match(req)
            chunks, starts, seq_ends = self._plan_chunks(req, skip)
            self._prefilling.append(_Prefill(slot, req, chunks, starts,
                                             seq_ends, self.clock(),
                                             cached_len=skip))
            if node is not None:
                clones.setdefault(node.key, (node, []))[1].append(slot)
                self.prefix_hits += 1
                self.prefix_hit_tokens += skip
            self.prefill_tokens_computed += len(req.prompt) - skip
            self.prefill_tokens_served += len(req.prompt)
            self._m.prefill_tokens.labels(source="computed").inc(
                len(req.prompt) - skip)
            self._m.prefill_tokens.labels(source="cached").inc(skip)
            n += 1
        block = self.engine.prefix_block
        for node, slots in clones.values():
            for link in self.prefix_store.chain(node):
                self.pool = self.engine.bulk_insert(
                    self.pool, slots,
                    ExistingPrefix(link.pages, link.n_tokens),
                    start=link.n_tokens - block)
        self._m.queue_depth.set(len(self.queue))
        return n

    def _intern_prefix(self, pf: _Prefill) -> None:
        """Intern a finished prompt's block-aligned pages (at activation,
        when the lane holds the whole prompt). The store clones them out
        of the lane's views; the ``missing`` pre-check skips a prefix
        already interned."""
        store = self.prefix_store
        if store is None or self.engine.prefix_len(pf.req):
            return
        n = len(pf.req.prompt) // store.block * store.block
        if not n or not store.missing(pf.req.prompt[:n]):
            return
        store.insert(pf.req.prompt[:n], _cache.extract_slot(self.pool,
                                                            pf.slot))

    def _prefill_whole(self, slot: int, req: GenerateRequest) -> None:
        """Run-to-completion regime: prefill the whole prompt, batch 1 at
        its exact length (no padding reaches a router), copy its cache into
        lane ``slot`` and start the lane."""
        if self.n_active:
            self.full_prefill_stalls += 1
        t_admit = self.clock()
        plen = len(req.prompt)
        self.prefill_tokens_computed += plen
        self.prefill_tokens_served += plen
        self._m.prefill_tokens.labels(source="computed").inc(plen)
        t0 = time.perf_counter()
        logits, req_cache = _prefill(
            self.engine, np.asarray(req.prompt, np.int32)[None], req.frames,
            req.patches)
        self.pool = self.engine.insert(self.pool, slot, req_cache)
        self.full_prefill_seconds.append(time.perf_counter() - t0)
        self._start_lane(_Prefill(slot, req, [], [], [], t_admit), logits,
                         [])

    def _start_lane(self, pf: _Prefill, logits, done: list) -> None:
        """Prefill finished: seed the lane with the prompt's sampled first
        token (emission 0 of its key schedule) and write its schedule
        (seed, next step 1) into the pool."""
        sp = pf.req.sampling or GREEDY
        first = self.engine.sample_first(logits, sp)
        self.pool = self.engine.set_sampling_state(self.pool, pf.slot,
                                                   sp.seed, 1)
        now = self.clock()
        timer = self._timers.get(pf.req.rid)
        if timer is not None:
            timer.to("decode")
        if pf.req.arrival is not None:
            self._m.ttft.observe(now - pf.req.arrival)
        lane = _Lane(req=pf.req, tokens=[first],
                     remaining=pf.req.max_new_tokens - 1, t_admit=pf.t_admit,
                     t_first=now, token_times=[now],
                     cached_len=pf.cached_len)
        self.lanes[pf.slot] = lane
        self._m.active_lanes.set(self.n_active)
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
        kw = {}
        if k == 0 and self.engine.prefix_len(pf.req):
            kw["patches"] = pf.req.patches
        t0 = self.clock()
        logits, self.pool = self.engine.prefill_chunk(
            self.pool, pf.slot, pf.chunks[k], pf.starts[k], pf.seq_ends[k],
            final, **kw)
        self._m.prefill_chunk.observe(self.clock() - t0)
        pf.next_chunk += 1
        if final:
            self._prefilling.popleft()
            self._intern_prefix(pf)
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
            self._m.queue_depth.set(len(self.queue))
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

    def _append_token(self, slot: int, tok: int, done: list) -> bool:
        """Commit one emitted token to lane ``slot``: record it, stream it,
        and retire the lane if it hit a finish reason. → whether it
        retired."""
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
        return reason is not None

    def _recover_lane(self, slot: int, temps, tks, tps, done: list) -> None:
        """Non-finite logits on lane ``slot`` this step: rewind the poisoned
        append bitwise (K/V, scales, LOP features, key step), turn the
        lane's drafting off for good, recompute the token once through the
        engine's single-lane no-LOP retry, and retire the lane with reason
        "fault" only if that fails too."""
        lane = self.lanes[slot]
        self.fault_events += 1
        self._m.fault_events.inc()
        self.fault_rids.add(lane.req.rid)
        lane.no_spec = True
        self.pool = self.engine.rollback(self.pool, slot, 1)
        toks, ok, self.pool = self.engine.retry_step(
            self.pool, slot, self._next_tok, temps, tks, tps)
        if not bool(ok[slot]):
            self.pool = self.engine.rollback(self.pool, slot, 1)
            self.fault_finishes += 1
            self._m.fault_finishes.inc()
            done.append(self._finish(slot, "fault"))
            return
        self.fault_recoveries += 1
        self._m.fault_recoveries.inc()
        self._append_token(slot, int(toks[slot]), done)

    # ---------------- speculative decoding ----------------

    def _lane_kv_len(self, slot: int) -> int:
        """Committed cache length of lane ``slot``: positions [0, L) hold
        written K/V; the pending ``_next_tok`` goes to position L."""
        lane = self.lanes[slot]
        return (self.engine.prefix_len(lane.req) + len(lane.req.prompt)
                + len(lane.tokens) - 1)

    def _spec_gamma(self) -> int:
        """This round's draft length: the least over active lanes of the
        request's γ (``sampling.gamma``, 0 = ``gamma``), its token budget
        left and its capacity headroom (verify writes γ+1 rows at
        [L, L+γ+1)). 0 — plain decode for the whole cycle — when any lane
        drafts no more: the batched draft cannot leave one lane out."""
        g = None
        for slot, lane in enumerate(self.lanes):
            if lane is None:
                continue
            if lane.no_spec:
                return 0
            sp = lane.req.sampling or GREEDY
            lane_g = min(sp.gamma if sp.gamma > 0 else self.gamma,
                         lane.remaining,
                         self.capacity - 1 - self._lane_kv_len(slot))
            g = lane_g if g is None else min(g, lane_g)
        return max(0, g or 0)

    def _spec_round(self, g: int, temps, tks, tps, done: list) -> None:
        """One speculative cycle: ``g`` batched draft steps propose tokens
        for every active lane, then one chunk-shaped verify a lane scores
        all g+1 positions exactly; the agreeing drafts and the verifier's
        next token are emitted and the rejected tail is rewound.

        Greedy lanes emit the plain-decode stream of exact attention (the
        verify rows are the dense decode's logits through the chunk
        carry); a sampled lane draws draft i and its verify row under the
        same lane-local key, so it emits the non-speculative same-seed
        stream. Finish reasons are checked per emitted token: a finish
        inside the accepted window evicts the lane there, and a
        cancellation or deadline mid-window keeps what was emitted and
        rewinds the rest.
        """
        self.spec_rounds += 1
        active = [s for s, lane in enumerate(self.lanes) if lane is not None]
        base_e = {s: len(self.lanes[s].tokens) for s in active}
        base_len = {s: self._lane_kv_len(s) for s in active}
        drafts: dict = {s: [] for s in active}
        cur = self._next_tok.copy()
        for _ in range(g):
            t0 = self.clock()
            toks, self.pool = self.engine.draft(self.pool, cur, temps, tks,
                                                tps)
            dt = self.clock() - t0
            self._m.spec_draft.observe(dt)
            self.draft_seconds.append(dt)
            self.draft_launches += 1
            for s in active:
                drafts[s].append(int(toks[s]))
                cur[s, 0] = toks[s]
        self.spec_drafted += g * len(active)

        for slot in active:
            lane = self.lanes[slot]
            start = base_len[slot]
            if start + g + 1 > self.capacity:
                raise AssertionError(f"speculative verify would write past "
                                     f"capacity ({start}+{g}+1 > "
                                     f"{self.capacity})")
            block = np.concatenate([self._next_tok[slot],
                                    np.asarray(drafts[slot], np.int32)])[None]
            t0 = self.clock()
            logits, self.pool = self.engine.verify_chunk(self.pool, slot,
                                                         block, start)
            self._m.spec_verify.observe(self.clock() - t0)
            finite = bool(torch.isfinite(logits).all())
            self.verify_seconds.append(self.clock() - t0)
            self.spec_verify_launches += 1
            if not finite:
                # poisoned verify: rewind the round (g drafts + 1) and stop
                # the lane's drafting; the next plain decode recomputes the
                # token through the NaN guard and retry
                self.pool = self.engine.rollback(self.pool, slot, g + 1)
                lane.no_spec = True
                self.fault_events += 1
                self._m.fault_events.inc()
                self.fault_rids.add(lane.req.rid)
                continue
            sp = lane.req.sampling or GREEDY
            targets = self.engine.sample_block(logits, sp, base_e[slot])
            j = 0
            while j < g and drafts[slot][j] == int(targets[j]):
                j += 1
            self.spec_accepted += j
            if j == 0:
                lane.zero_accept_rounds += 1
                if lane.zero_accept_rounds >= self.spec_watchdog:
                    lane.no_spec = True
                    self.spec_watchdog_trips += 1
            else:
                lane.zero_accept_rounds = 0
            finished = False
            for tok in (int(t) for t in targets[:j + 1]):
                abort = self._abort_reason(lane.req)
                if abort is not None:
                    emitted = len(lane.tokens) - base_e[slot]
                    self.pool = self.engine.rollback(self.pool, slot,
                                                     g + 1 - emitted)
                    if abort == "deadline":
                        self.deadline_count += 1
                    done.append(self._finish(slot, abort))
                    finished = True
                    break
                self.spec_emitted += 1
                if self._append_token(slot, tok, done):
                    finished = True
                    break
            if not finished and j < g:
                # lengths start+g+1 → start+j+1
                self.pool = self.engine.rollback(self.pool, slot, g - j)

    def step(self) -> list[FinishedRequest]:
        """One serve cycle: terminal sweep (cancellations and deadlines),
        ≤ 1 prefill chunk, then one decode step over every active lane (or
        one speculative round). → the requests that finished."""
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
        if self.spec:
            g = self._spec_gamma()
            if g >= 1:
                self._spec_round(g, temps, tks, tps, done)
                return done
        t0 = self.clock()
        toks, self.pool = self.engine.decode_step(self.pool, self._next_tok,
                                                  temps, tks, tps)
        dt = self.clock() - t0
        self._m.decode_step.observe(dt)
        self.decode_seconds.append(dt)
        self.decode_launches += 1
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
            token_times=lane.token_times, cached_len=lane.cached_len)
        self.pool = self.engine.evict(self.pool, slot)
        self.lanes[slot] = None
        self._free.append(slot)
        self._next_tok[slot, 0] = 0
        self.results.append(res)
        self._m.active_lanes.set(self.n_active)
        self._publish_finish(res, reason)
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
        self._publish_finish(res, reason)
        return res

    def _publish_finish(self, res: FinishedRequest, reason: str) -> None:
        """The registry's side of a retirement: the outcome and deadline
        counters, tokens, end-to-end latency, the inter-token gaps and the
        request's stage spans."""
        self._m.requests.labels(outcome=reason).inc()
        if reason == "deadline":
            self._m.deadline.inc()
        self._m.tokens.inc(len(res.tokens))
        self._m.e2e.observe(res.latency)
        for gap in res.itl:
            self._m.itl.observe(gap)
        timer = self._timers.pop(res.rid, None)
        if timer is not None:
            for stage, span in timer.finish().items():
                self._m.stage_seconds.labels(stage=stage).observe(span)

    # ---------------- invariants ----------------

    def check_invariants(self) -> None:
        """Cross-check host bookkeeping against the pool; raises
        AssertionError on a broken contract.

        - every slot is exactly one of occupied, reserved (mid-prefill) or
          free;
        - the pool's ``active`` mask equals the occupied set;
        - lengths stay within capacity (an attention-free pool has none),
          and an occupied lane's length is
          its prompt plus its emissions minus the one pending token;
        - a sampled lane's ``sample_step`` equals its emission count (so
          rollback and retry net to exactly the tokens delivered);
        - the prefix store's own structure holds.
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
        if self.capacity and int(lengths.max(initial=0)) > self.capacity:
            raise AssertionError(f"lane length {int(lengths.max())} exceeds "
                                 f"capacity {self.capacity}")
        if int(steps.min(initial=0)) < 0:
            raise AssertionError(f"negative sample_step: {steps}")
        for slot in occupied:
            lane = self.lanes[slot]
            want = self._lane_kv_len(slot)
            if int(lengths[slot]) != want:
                raise AssertionError(f"slot {slot}: length "
                                     f"{int(lengths[slot])} != {want}")
            sp = lane.req.sampling
            if sp is not None and not sp.greedy \
                    and int(steps[slot]) != len(lane.tokens):
                raise AssertionError(
                    f"slot {slot}: sample_step {int(steps[slot])} != "
                    f"emissions {len(lane.tokens)}")
        if self.prefix_store is not None:
            self.prefix_store.check_invariants()

    def run_to_completion(self) -> list[FinishedRequest]:
        """Drain the queue and every lane (all requests already submitted)."""
        while self.has_work():
            self.admit()
            self.step()
        return self.results


def _prefill(eng, tokens, frames=None, patches=None):
    """``eng.prefill`` of tokens [1, S], given the encoder ``frames`` and
    the image ``patches`` only when the request has them."""
    kw = {name: rows for name, rows in (("frames", frames),
                                        ("patches", patches))
          if rows is not None}
    return eng.prefill(tokens, **kw)


def lockstep_generate(eng: PooledEngine, prompt, max_new_tokens: int, *,
                      eos_id: int | None = None,
                      sampling: SamplingParams | None = None, stop=(),
                      on_token=None, cancel=None, frames=None,
                      patches=None) -> list:
    """Batch-1 reference: whole-prompt prefill, then one decode step per
    token, through the same engine and sampler as a :class:`Scheduler` on
    it (so the same ``max_len``, cache capacity, LOP budget and key
    schedule). Honors eos, stop sequences, ``on_token`` and ``cancel``;
    ``frames`` is an encdec request's encoder input, ``patches`` a vlm
    request's image prefix."""
    sp = sampling or GREEDY
    req = GenerateRequest(rid=-1, prompt=np.asarray(prompt, np.int32),
                          max_new_tokens=max_new_tokens, eos_id=eos_id,
                          sampling=sp, stop=stop, on_token=on_token,
                          cancel=cancel, frames=frames, patches=patches)
    logits, cache = _prefill(eng, req.prompt[None], frames, patches)
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
