"""Serving API of the port: requests, results and the pooled engine.

:class:`PooledEngine` wraps the engine functions behind the lifecycle the
scheduler speaks — ``init_pool`` / ``prefill`` / ``prefill_chunk`` /
``insert`` / ``extract`` / ``decode_step`` / ``evict`` / ``sample_first``
— with greedy sampling (argmax, first maximal index). Seeded sampling,
stop sequences, deadlines, faults, prefix caching and speculative decoding
are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.serving import cache as _cache
from repro_torch.serving.engine import prefill, prefill_chunk, serve_step
from repro_torch.models.transformer import init_params
from repro_torch.serving.quantize import quantize_params


@dataclass(frozen=True, eq=False)
class GenerateRequest:
    """One generation request: prompt, token budget, optional EOS id."""
    rid: int
    prompt: np.ndarray                 # int32 [prompt_len]
    max_new_tokens: int
    eos_id: int | None = None
    arrival: float | None = None


@dataclass(frozen=True, eq=False)
class FinishedRequest:
    """Completed request: emitted tokens and its latency breakdown."""
    rid: int
    prompt_len: int
    tokens: list
    finish_reason: str                 # "eos" | "length"
    t_arrival: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0
    token_times: list = field(default_factory=list)

    @property
    def ttft(self) -> float:
        return self.t_first - self.t_arrival


class PooledEngine:
    """The slot-paged serving stack for one model on one device.

    ``device`` defaults to the CUDA card (raising when there is none);
    tests pass ``device="cpu"`` to run the plain kernel versions. Pool
    operations update the pool in place and return it.
    """

    def __init__(self, cfg, qp, *, max_len: int, use_lop: bool = True,
                 device=None):
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

    def decode_step(self, pool, tokens):
        """Advance every active lane one token, greedily.
        tokens [B, 1] → (np.int32 [B], pool)."""
        logits, pool = serve_step(self.cfg, self.qp, pool,
                                  self._tokens(tokens), use_lop=self.use_lop)
        return (torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy(),
                pool)

    def sample_first(self, logits) -> int:
        """A request's first token from its prefill logits [1, V]."""
        return int(torch.argmax(logits[0]).item())
