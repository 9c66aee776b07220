"""Serving API of the port: sampling params, requests, results and the
pooled engine.

* :class:`SamplingParams` — per-request decode policy (greedy /
  temperature / top-k / top-p + PRNG seed); the sampling contract lives in
  :mod:`repro_torch.serving.sampling`.
* :class:`GenerateRequest` — prompt, budget, eos, stop token sequences, an
  optional streaming ``on_token`` callback, a :class:`CancelToken` and a
  ``deadline_ms`` latency budget.
* :class:`StepResult` — one streamed token; :class:`FinishedRequest` — the
  completed request with its finish reason and latency breakdown.
* :class:`PooledEngine` — the lifecycle the scheduler speaks:
  ``init_pool`` / ``prefill`` / ``prefill_chunk`` / ``insert`` /
  ``extract`` / ``decode_step`` / ``retry_step`` / ``rollback`` /
  ``evict`` / ``sample_first`` / ``set_sampling_state``.

Sampling state lives in the pool (``seed`` / ``sample_step``):
``decode_step`` reads each lane's key schedule there and advances it with
the lane. After every ``decode_step`` the engine publishes ``last_ok``
(np bool [B]), each lane's logit finiteness for that step; ``retry_step``
recomputes one quarantined lane with the LOP screen off (the dense decode
kernel) against a pool already rewound by ``rollback``. Prefix caching and
speculative decoding are not ported yet.

Like the reference's four compiled decode functions, ``decode_step`` and
``retry_step`` run one of four entries (greedy or sampled decode, greedy
or sampled retry), each one function of device tensors alone
(``PooledEngine._step``). On a card each entry replays a CUDA graph of
the whole step (:mod:`repro_torch.serving.graphs`); on the CPU it runs
eagerly on the plain kernel versions.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.transformer import init_params
from repro_torch.serving import cache as _cache
from repro_torch.serving import faults as _faults
from repro_torch.serving.engine import (guard_logits, prefill, prefill_chunk,
                                        serve_step)
from repro_torch.serving.graphs import StepGraphs
from repro_torch.serving.quantize import quantize_params
from repro_torch.serving.sampling import sample_with_seed


@dataclass(frozen=True)
class SamplingParams:
    """Per-request decode policy. ``temperature <= 0`` is the greedy fast
    path (bitwise argmax); ``top_k <= 0`` and ``top_p >= 1`` disable their
    filters; ``seed`` drives the lane-local key schedule."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


GREEDY = SamplingParams()


class CancelToken:
    """Mutable cancellation handle carried by a frozen request: the
    submitter calls :meth:`cancel`; the scheduler retires the request at
    its next serve cycle (queued, mid-prefill or mid-decode) with reason
    ``"cancelled"``."""

    __slots__ = ("_cancelled",)

    def __init__(self) -> None:
        self._cancelled = False

    def cancel(self) -> None:
        self._cancelled = True

    @property
    def cancelled(self) -> bool:
        return self._cancelled


@dataclass(frozen=True)
class StepResult:
    """One streamed token: ``index`` is its 0-based position in the
    generated stream; ``finished`` marks the request's final token, with
    ``finish_reason`` "eos" | "stop" | "length" (a cancellation, deadline
    or fault emits no token)."""
    rid: int
    token: int
    index: int
    finished: bool
    finish_reason: str = ""


@dataclass(frozen=True, eq=False)
class GenerateRequest:
    """One generation request (frozen envelope).

    ``stop`` holds token sequences: decoding finishes with reason "stop"
    as soon as the generated stream ends with one of them (the matched
    suffix stays in ``tokens``). ``on_token`` streams every emitted token
    in order; ``cancel`` is the mid-flight abort handle; ``deadline_ms``
    is the latency budget from ``arrival`` (stamped at submit when None).
    """
    rid: int
    prompt: np.ndarray                 # int32 [prompt_len]
    max_new_tokens: int
    eos_id: int | None = None
    sampling: SamplingParams = GREEDY
    stop: tuple = ()                   # tuple[tuple[int, ...], ...]
    on_token: Callable[[StepResult], None] | None = None
    cancel: CancelToken | None = None
    arrival: float | None = None
    deadline_ms: float | None = None

    def __post_init__(self):
        # hashable int tuples from any iterable of iterables; empty
        # sequences dropped
        stop = tuple(tuple(int(t) for t in seq) for seq in self.stop)
        object.__setattr__(self, "stop", tuple(s for s in stop if s))

    @property
    def cancelled(self) -> bool:
        return self.cancel is not None and self.cancel.cancelled


@dataclass(frozen=True, eq=False)
class FinishedRequest:
    """Completed request: emitted tokens and its latency breakdown.
    ``token_times`` stamps each token's emission (index 0 == ``t_first``);
    a request retired before its first token has empty ``tokens`` and
    ``t_first == t_done``."""
    rid: int
    prompt_len: int
    tokens: list
    finish_reason: str                 # "eos" | "stop" | "length" |
    #                                    "cancelled" | "deadline" |
    #                                    "shed" | "fault"
    t_arrival: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0
    token_times: list = field(default_factory=list)

    @property
    def ttft(self) -> float:
        return self.t_first - self.t_arrival

    @property
    def latency(self) -> float:
        return self.t_done - self.t_arrival

    @property
    def itl(self) -> list:
        """Inter-token latencies (seconds), one per token after the first."""
        return [b - a for a, b in zip(self.token_times, self.token_times[1:])]


def _int32(x: int) -> int:
    """A Python int wrapped to int32, as the reference's pool stores it."""
    return (int(x) + 2 ** 31) % 2 ** 32 - 2 ** 31


def _f32_bits(values, n: int) -> np.ndarray:
    return np.broadcast_to(np.asarray(values, np.float32), (n,)).view(
        np.int32)


def step_inputs(tokens, fault_add, temperature, top_k, top_p,
                slot: int = 0) -> np.ndarray:
    """A decode entry's host inputs as one int32 [6, B] array, uploaded in
    one copy: the tokens, the fault add (zeros without a plan), the
    temperature, top-k, top-p (f32 rows as their bits) and the retry's
    slot (row 5, every column)."""
    tokens = np.asarray(tokens, np.int32).reshape(-1)
    n = tokens.shape[0]
    host = np.empty((6, n), np.int32)
    host[0] = tokens
    host[1] = _f32_bits(0.0 if fault_add is None else fault_add, n)
    host[2] = _f32_bits(temperature, n)
    host[3] = np.asarray(top_k, np.int32)
    host[4] = _f32_bits(top_p, n)
    host[5] = slot
    return host


def _unpack(inp: torch.Tensor):
    """Device views of :func:`step_inputs`' rows. → (tokens int64 [B, 1],
    fault add, temperature, top-k, top-p, slot (a 0-d int32))."""
    f32 = torch.float32
    return (inp[0].to(torch.int64)[:, None], inp[1].view(f32),
            inp[2].view(f32), inp[3], inp[4].view(f32), inp[5, 0])


class PooledEngine:
    """The slot-paged serving stack for one model on one device.

    ``device`` defaults to the CUDA card (raising when there is none);
    tests pass ``device="cpu"`` to run the plain kernel versions. Pool
    operations update the pool in place and return it.

    On a card the decode entries replay CUDA graphs
    (:class:`repro_torch.serving.graphs.StepGraphs`, ``self.graphs``);
    ``graphs=False`` runs them eagerly instead, which only a caller holding
    the graphs to the eager step (or timing the two) asks for. The CPU
    builds no graph.
    """

    def __init__(self, cfg, qp, *, max_len: int, use_lop: bool = True,
                 device=None, graphs: bool = True):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # the f32 head matmul (outside any kernel) runs in full f32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.qp = qp
        self.max_len = max_len
        self.use_lop = use_lop
        self.chunk_tokens = cfg.lop_block
        self.supports_chunked = cfg.family == "dense"
        self.last_ok = None            # np bool [B] after each decode_step
        self.graphs = (StepGraphs(self.device)
                       if graphs and self.device.type == "cuda" else None)

    @classmethod
    def from_seed(cls, cfg, *, seed: int, max_len: int, device=None, **kw):
        """Engine over seeded random weights drawn on ``device``."""
        dev = resolve_device(device)
        return cls(cfg, quantize_params(cfg, init_params(cfg, seed, dev)),
                   max_len=max_len, device=dev, **kw)

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(np.asarray(tokens, np.int64),
                               device=self.device)

    # ---------------- pool ----------------

    def init_pool(self, n_slots: int) -> dict:
        return _cache.init_cache_pool(self.cfg, n_slots, self.max_len,
                                      self.device)

    def insert(self, pool, slot: int, req_cache) -> dict:
        return _cache.insert_slot(pool, slot, req_cache)

    def extract(self, pool, slot: int) -> dict:
        return _cache.extract_slot(pool, slot)

    def evict(self, pool, slot: int) -> dict:
        return _cache.evict_slot(pool, slot)

    # ---------------- prefill ----------------

    def prefill(self, tokens):
        """Whole-prompt prefill of tokens [B, S] → (logits [B, V], cache)."""
        return prefill(self.cfg, self.qp, self._tokens(tokens),
                       max_len=self.max_len)

    def prefill_chunk(self, pool, slot: int, tokens, start: int,
                      seq_end: int, activate: bool):
        """One chunk into the reserved lane ``slot``: the chunk's K/V land
        in the pool through the lane's views; the final chunk activates
        the lane. → (logits [1, V], pool)."""
        lane = _cache.extract_slot(pool, slot)
        logits, lane = prefill_chunk(self.cfg, self.qp, self._tokens(tokens),
                                     lane, start=start, seq_end=seq_end)
        pool = _cache.insert_slot(pool, slot, lane, active=activate)
        return logits, pool

    # ---------------- decode ----------------

    def _vec(self, values, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, dtype), device=self.device)

    def _pick(self, logits, pool, active, sampled: bool, temperature, top_k,
              top_p):
        """Argmax (``sample_step`` stays put), or each lane's sample under
        its in-pool key schedule, after which ``sample_step`` moves in
        place by ``active`` (by 1 in a cache without one)."""
        if not sampled:
            return torch.argmax(logits, dim=-1)
        steps = pool["sample_step"]
        toks = sample_with_seed(logits, pool["seed"], steps, temperature,
                                top_k, top_p)
        steps.add_(1 if active is None else active.to(torch.int32))
        return toks

    def _step(self, pool, inp, entry: str) -> torch.Tensor:
        """One decode entry — ``"greedy"``, ``"sampled"``,
        ``"retry_greedy"`` or ``"retry_sampled"`` — on device tensors
        alone: ``inp`` is :func:`step_inputs` on the device. The step,
        the fault add, the finiteness guard, the argmax or sampler and the
        pool updates, all in place. → int32 [2, B]: tokens, finiteness."""
        tokens, fadd, temperature, top_k, top_p, slot = _unpack(inp)
        retry = entry.startswith("retry")
        active = pool.get("active")
        if retry:
            lanes = torch.arange(active.shape[0], device=active.device)
            active = active & (lanes == slot)
        logits, pool = serve_step(self.cfg, self.qp, pool, tokens,
                                  use_lop=self.use_lop and not retry,
                                  active=active)
        logits, ok = guard_logits(logits, fadd)
        toks = self._pick(logits, pool, active, entry.endswith("sampled"),
                          temperature, top_k, top_p)
        return torch.stack([toks.to(torch.int32), ok.to(torch.int32)])

    def _run(self, entry: str, pool, host):
        """``_step`` through the entry's graph on a card (eagerly with
        ``graphs=False`` and on the CPU), then the step's one host
        transfer. → (tokens np.int32 [B], ok np.bool [B])."""
        if self.graphs is not None:
            out = self.graphs.run(self._step, entry, pool, host)
        else:
            inp = torch.from_numpy(host).to(self.device, non_blocking=True)
            out = self._step(pool, inp, entry)
        both = out.cpu().numpy()
        return both[0], both[1].astype(bool)

    @staticmethod
    def _entry(temperature, retry: bool = False) -> str:
        """The host-side choice: greedy when every lane is greedy."""
        mode = ("greedy" if np.all(np.asarray(temperature) <= 0.0)
                else "sampled")
        return f"retry_{mode}" if retry else mode

    def decode_step(self, pool, tokens, temperature, top_k, top_p):
        """Advance every active lane one token and sample it.
        tokens [B, 1]; temperature/top_k/top_p per lane [B].
        → (np.int32 [B], pool); ``self.last_ok`` holds each lane's logit
        finiteness for this step. When every lane is greedy the sampler is
        skipped for a bare argmax and ``sample_step`` does not move;
        otherwise each lane samples under its in-pool key schedule and
        active lanes' ``sample_step`` advances. An active
        :mod:`repro_torch.serving.faults` plan injects here."""
        n = np.asarray(tokens).shape[0]
        host = step_inputs(tokens, _faults.decode_fault_add(n), temperature,
                           top_k, top_p)
        toks, self.last_ok = self._run(self._entry(temperature), pool, host)
        return toks, pool

    def retry_step(self, pool, slot: int, tokens, temperature, top_k, top_p):
        """Recovery step for ONE quarantined lane whose faulted append was
        rewound (``rollback``): the lane recomputes its token with the LOP
        screen off — the dense decode kernel — while every other lane is
        masked inactive (its lengths, K/V and key schedule do not move;
        ``pool["active"]`` is read, never written). ``sample_step``
        advances only on the sampled path.
        → (np.int32 [B], np.bool [B], pool); only row ``slot`` means
        anything. A sticky injected fault still poisons the retry."""
        n = np.asarray(tokens).shape[0]
        host = step_inputs(tokens, _faults.retry_fault_add(n), temperature,
                           top_k, top_p, slot=slot)
        toks, ok = self._run(self._entry(temperature, retry=True), pool,
                             host)
        return toks, ok, pool

    def rollback(self, pool, slot: int, n: int) -> dict:
        """Rewind lane ``slot`` by ``n`` appends
        (:func:`repro_torch.serving.cache.rollback_slot`)."""
        return _cache.rollback_slot(pool, slot, n)

    def set_sampling_state(self, pool, slot: int, seed: int,
                           step: int) -> dict:
        """Write lane ``slot``'s key schedule (at activation ``step=1``:
        the prefill-seeded first token was emission 0)."""
        pool["seed"][slot] = _int32(seed)
        pool["sample_step"][slot] = step
        return pool

    def sample_first(self, logits, sampling: SamplingParams | None = None,
                     seed_step: int = 0) -> int:
        """A request's first token from its prefill logits [1, V], through
        the decode step's sampler at key-schedule step ``seed_step``."""
        sp = sampling or GREEDY
        if sp.greedy:
            return int(torch.argmax(logits[0]).item())
        tok = sample_with_seed(logits[:1],
                               self._vec([_int32(sp.seed)], np.int32),
                               self._vec([seed_step], np.int32),
                               self._vec([sp.temperature], np.float32),
                               self._vec([sp.top_k], np.int32),
                               self._vec([sp.top_p], np.float32))
        return int(tok[0].item())
