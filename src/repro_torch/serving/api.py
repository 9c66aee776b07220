"""Serving API of the port: sampling params, requests, results and the
pooled engine.

* :class:`SamplingParams` — per-request decode policy (greedy /
  temperature / top-k / top-p + PRNG seed); the sampling contract lives in
  :mod:`repro_torch.serving.sampling`.
* :class:`GenerateRequest` — prompt, budget, eos, stop token sequences, an
  optional streaming ``on_token`` callback, a :class:`CancelToken`, a
  ``deadline_ms`` latency budget and, for an encdec model, the encoder
  ``frames``, for a vlm model the image prefix ``patches``.
* :class:`StepResult` — one streamed token; :class:`FinishedRequest` — the
  completed request with its finish reason and latency breakdown.
* :class:`ExistingPrefix` — interned prefix pages to resume a prompt from.
* :class:`PooledEngine` — the lifecycle the scheduler speaks:
  ``init_pool`` / ``prefill`` / ``prefill_chunk`` / ``insert`` /
  ``bulk_insert`` / ``extract`` / ``decode_step`` / ``retry_step`` /
  ``draft`` / ``verify_chunk`` / ``sample_block`` / ``rollback`` /
  ``evict`` / ``sample_first`` / ``set_sampling_state``.

Sampling state lives in the pool (``seed`` / ``sample_step``):
``decode_step`` reads each lane's key schedule there and advances it with
the lane. After every ``decode_step`` the engine publishes ``last_ok``
(np bool [B]), each lane's logit finiteness for that step; ``retry_step``
recomputes one quarantined lane with the LOP screen off (the dense decode
kernel) against a pool already rewound by ``rollback``.

Like the reference's six compiled step functions, ``decode_step``,
``retry_step`` and ``draft`` run one of six entries (greedy or sampled
decode, retry and speculative draft), each one function of device tensors
alone (``PooledEngine._step``). On a card each entry replays a CUDA graph
of the whole step (:mod:`repro_torch.serving.graphs`); on the CPU it runs
eagerly on the plain kernel versions. ``verify_chunk`` (a γ+1-row chunk
scored exactly) runs eagerly, like ``prefill_chunk``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import autotune
from repro_torch.serving import cache as _cache
from repro_torch.serving import faults as _faults
from repro_torch.serving.engine import (chunks_prefill, guard_logits,
                                        prefill, prefill_chunk, serve_step)
from repro_torch.serving.graphs import StepGraphs
from repro_torch.serving.quantize import init_serving_params
from repro_torch.serving.sampling import sample_with_seed


@dataclass(frozen=True)
class SamplingParams:
    """Per-request decode policy. ``temperature <= 0`` is the greedy fast
    path (bitwise argmax); ``top_k <= 0`` and ``top_p >= 1`` disable their
    filters; ``seed`` drives the lane-local key schedule. ``gamma`` is the
    request's speculative draft length when the scheduler speculates (0
    defers to the scheduler's γ; ignored otherwise)."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    gamma: int = 0

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
    ``frames`` (np f32 [S_enc, D]) is an encdec request's encoder input;
    ``patches`` (np f32 [n_img, D]) a vlm request's stub patch embeddings,
    which take the lane's first n_img cache positions.
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
    frames: np.ndarray | None = None   # encdec encoder input [S_enc, D]
    patches: np.ndarray | None = None  # vlm image prefix [n_img, D]

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
    cached_len: int = 0                # prompt tokens served from the
    #                                    prefix cache (0 = cold prefill)

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


@dataclass(frozen=True)
class ExistingPrefix:
    """A computed prefill prefix to resume from: ``cache`` is a batch-1
    tree of block-aligned prefix pages (K/V, scales and packed LOP feature
    rows for the first ``common_len`` positions, ``lengths ==
    [common_len]``), as :meth:`repro_torch.serving.cache.PrefixStore.
    assemble` builds it. ``PooledEngine.bulk_insert`` clones it into many
    lanes; each resumes chunked prefill at ``start = common_len``, so a
    hit decodes token-identically to a cold prefill."""
    cache: dict
    common_len: int


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

    On a card the step entries (decode, retry, draft) replay CUDA graphs
    (:class:`repro_torch.serving.graphs.StepGraphs`, ``self.graphs``);
    ``graphs=False`` runs them eagerly instead, which only a caller holding
    the graphs to the eager step (or timing the two) asks for. The CPU
    builds no graph. ``chunk_tokens`` (default ``lop_block``) is the
    prefill chunk width; prefix pages stay ``lop_block``-aligned, so a
    prefix hit resumes at a block multiple and chunks from there.
    ``draft_layers`` (default ``n_layers // 2``) and ``draft_k`` (default
    1) shape the speculative draft. ``shape_log`` (a path) arms the tile
    autotuner's shape log: every distinct kernel dispatch shape the engine
    runs lands in that JSON file, which ``python -m
    repro_torch.kernels.autotune --from-log PATH`` sweeps on the card.
    """

    def __init__(self, cfg, qp, *, max_len: int, use_lop: bool = True,
                 device=None, graphs: bool = True,
                 chunk_tokens: int | None = None,
                 draft_layers: int | None = None,
                 draft_k: int | None = None,
                 shape_log: str | None = None):
        self.device = resolve_device(device)
        if shape_log is not None:
            autotune.start_shape_log(shape_log)
        if self.device.type == "cuda":
            # the f32 head matmul (outside any kernel) runs in full f32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.qp = qp
        self.max_len = max_len
        self.use_lop = use_lop
        self.chunk_tokens = chunk_tokens or cfg.lop_block
        # ---- capability declarations (family → behaviour, once) ----
        self.supports_chunked = chunks_prefill(cfg)
        self.exact_length_prefill = not self.supports_chunked
        self.has_image_prefix = cfg.family == "vlm"
        self.state_kind = _cache.STATE_KINDS[cfg.family]
        # prefix pages are lop_block-aligned and resume through the chunk
        # carry; speculation needs rewindable pages and a chunk-shaped
        # verify: both exist exactly where chunked prefill does (dense and
        # vlm; not in moe, encdec or the recurrent families, which prefill
        # whole prompts at their exact length)
        self.prefix_block = cfg.lop_block if self.supports_chunked else 0
        self.supports_speculative = self.supports_chunked
        # the draft: a layer-stack prefix and a pinched LOP budget
        self.draft_layers = min(cfg.n_layers, max(1, (
            draft_layers if draft_layers is not None
            else cfg.n_layers // 2)))
        self.draft_k = 1 if draft_k is None else max(1, draft_k)
        self.last_ok = None            # np bool [B] after each decode_step
        self.graphs = (StepGraphs(self.device)
                       if graphs and self.device.type == "cuda" else None)

    @classmethod
    def from_seed(cls, cfg, *, seed: int, max_len: int, device=None, **kw):
        """Engine over seeded random weights drawn on ``device``, one layer
        at a time (:func:`repro_torch.serving.quantize.
        init_serving_params`)."""
        dev = resolve_device(device)
        return cls(cfg, init_serving_params(cfg, seed, dev),
                   max_len=max_len, device=dev, **kw)

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(np.asarray(tokens, np.int64),
                               device=self.device)

    def _rows(self, rows):
        """Frames or patches (np f32 [S, D] or [B, S, D], or None) → a
        batched f32 tensor on the device."""
        if rows is None:
            return None
        rows = torch.as_tensor(np.asarray(rows, np.float32),
                               device=self.device)
        return rows[None] if rows.dim() == 2 else rows

    # ---------------- pool ----------------

    def init_pool(self, n_slots: int) -> dict:
        return _cache.init_cache_pool(self.cfg, n_slots, self.max_len,
                                      self.device)

    def prefix_len(self, req: GenerateRequest) -> int:
        """Cache positions a request holds before its text tokens: a vlm
        request's image rows (none for the other families, or a text-only
        vlm request)."""
        if self.has_image_prefix and req.patches is not None:
            return len(req.patches)
        return 0

    def insert(self, pool, slot: int, req_cache) -> dict:
        return _cache.insert_slot(pool, slot, req_cache)

    def bulk_insert(self, pool, slots, prefix: ExistingPrefix,
                    active: bool = False, start: int = 0) -> dict:
        """Clone one :class:`ExistingPrefix` into lanes ``slots`` (in
        place, one write a leaf). Lanes land inactive with length
        ``prefix.common_len``: they resume chunked prefill there. With
        ``start`` > 0 ``prefix.cache`` holds the positions ``[start,
        common_len)`` only — one store node of a chain whose earlier nodes
        went in before it."""
        pool = _cache.bulk_insert(pool, slots, prefix.cache, active=active,
                                  start=start)
        pool["lengths"][list(slots)] = prefix.common_len
        return pool

    def extract(self, pool, slot: int) -> dict:
        """A batch-1 *copy* of lane ``slot`` (lengths, pages — the cross
        pages and ``cross_len`` too —, recurrent state and key schedule):
        nothing done to the pool later reaches it."""
        def copy(tree):
            return {k: copy(v) if isinstance(v, dict) else v.clone()
                    for k, v in tree.items()}
        out = copy(_cache.extract_slot(pool, slot))
        for key in ("seed", "sample_step"):
            if key in pool:
                out[key] = pool[key][slot:slot + 1].clone()
        return out

    def evict(self, pool, slot: int) -> dict:
        return _cache.evict_slot(pool, slot)

    # ---------------- prefill ----------------

    def prefill(self, tokens, frames=None, patches=None):
        """Whole-prompt prefill of tokens [B, S] at their exact length →
        (logits [B, V], cache of the pool's capacity). ``frames`` (f32
        [S_enc, D] or [B, S_enc, D]) is an encdec model's encoder input,
        required there; ``patches`` (f32 [n_img, D] or [B, n_img, D]) a
        vlm request's image prefix."""
        return prefill(self.cfg, self.qp, self._tokens(tokens),
                       max_len=self.max_len, frames=self._rows(frames),
                       patches=self._rows(patches))

    def prefill_chunk(self, pool, slot: int, tokens, start: int,
                      seq_end: int, activate: bool, patches=None):
        """One chunk into the reserved lane ``slot``: the chunk's K/V land
        in the pool through the lane's views; the final chunk activates
        the lane; a vlm lane's first chunk carries its ``patches``. →
        (logits [1, V], pool)."""
        lane = _cache.extract_slot(pool, slot)
        logits, lane = prefill_chunk(self.cfg, self.qp, self._tokens(tokens),
                                     lane, start=start, seq_end=seq_end,
                                     patches=self._rows(patches))
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
        """One step entry — ``"greedy"``, ``"sampled"``,
        ``"retry_greedy"``, ``"retry_sampled"``, ``"draft_greedy"`` or
        ``"draft_sampled"`` — on device tensors alone: ``inp`` is
        :func:`step_inputs` on the device. The step, the fault add and the
        finiteness guard (not in a draft, as in the reference), the argmax
        or sampler and the pool updates, all in place. → int32 [2, B]:
        tokens, finiteness."""
        tokens, fadd, temperature, top_k, top_p, slot = _unpack(inp)
        retry = entry.startswith("retry")
        active = pool.get("active")
        if retry:
            lanes = torch.arange(active.shape[0], device=active.device)
            active = active & (lanes == slot)
        if entry.startswith("draft"):
            logits, pool = serve_step(
                self.cfg, self.qp, pool, tokens, use_lop=self.use_lop,
                active=active, n_layers=self.draft_layers,
                k_keep=self.draft_k)
            ok = torch.ones(logits.shape[0], dtype=torch.bool,
                            device=logits.device)
        else:
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
    def _entry(temperature, kind: str = "") -> str:
        """The host-side choice: greedy when every lane is greedy; ``kind``
        ``"retry"`` or ``"draft"`` names the retry's or the draft's twin."""
        mode = ("greedy" if np.all(np.asarray(temperature) <= 0.0)
                else "sampled")
        return f"{kind}_{mode}" if kind else mode

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
        toks, ok = self._run(self._entry(temperature, "retry"), pool, host)
        return toks, ok, pool

    # ---------------- speculative decoding ----------------

    def draft(self, pool, tokens, temperature, top_k, top_p):
        """One draft step over every active lane — the speculative
        proposer (``draft_layers`` layers, LOP budget ``draft_k``),
        batched like :meth:`decode_step` and sampled under the same
        in-pool key schedule (a sampled lane's ``sample_step`` advances).
        Its cache rows are provisional: verify overwrites them,
        ``rollback`` rewinds the rejected tail. No fault is injected here.
        → (np.int32 [B], pool)."""
        host = step_inputs(tokens, None, temperature, top_k, top_p)
        toks, _ = self._run(self._entry(temperature, "draft"), pool, host)
        return toks, pool

    def verify_chunk(self, pool, slot: int, tokens, start: int):
        """Score γ+1 positions of lane ``slot`` exactly in one chunk:
        ``tokens`` [1, γ+1] = [t_last, d_1..d_γ] at positions [start,
        start+γ+1), whose K/V are (re)written for every layer over the
        draft's provisional rows; the lane's length lands at start+γ+1 and
        its ``sample_step`` moves by 1 (with the γ draft advances and the
        rollback of γ−j rejected tokens, a lane that accepts j drafts nets
        j+1, its emissions). Runs eagerly. → (logits [1, γ+1, V] on the
        device, row i the target after position start+i; pool)."""
        width = np.asarray(tokens).shape[1]
        lane = _cache.extract_slot(pool, slot)
        logits, lane = prefill_chunk(self.cfg, self.qp, self._tokens(tokens),
                                     lane, start=start, seq_end=start + width,
                                     all_logits=True)
        pool = _cache.insert_slot(pool, slot, lane, active=True)
        pool["sample_step"][slot:slot + 1].add_(1)
        return logits, pool

    def sample_block(self, logits, sampling: SamplingParams | None,
                     first_step: int) -> np.ndarray:
        """Every row of verify logits [C, V] (or [1, C, V]) under one
        request's policy, row i at key-schedule step ``first_step + i`` —
        the keys the lane's decode steps would use, so the accepted sampled
        stream is the non-speculative one. → np.int32 [C]."""
        sp = sampling or GREEDY
        rows = logits[0] if logits.dim() == 3 else logits
        c = rows.shape[0]
        toks = sample_with_seed(
            rows, self._vec(np.full(c, _int32(sp.seed)), np.int32),
            self._vec(first_step + np.arange(c), np.int32),
            self._vec(np.full(c, sp.temperature), np.float32),
            self._vec(np.full(c, sp.top_k), np.int32),
            self._vec(np.full(c, sp.top_p), np.float32))
        return toks.cpu().numpy()

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
