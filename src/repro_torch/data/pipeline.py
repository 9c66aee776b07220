"""Synthetic sharded token pipeline, the reference's ``data/pipeline.py``
(numpy; its batches are the reference's, bit for bit).

Deterministic per (seed, step, host): every host makes only its own shard
of the batch (``process_index`` of ``process_count``). Sequences follow a
Zipf-ish token distribution with a deterministic bigram successor on half
the positions, so a model has something to learn (the loss falls).
``frames`` (encdec) and ``patches`` (vlm) are seeded pseudo-embeddings
standing in for the conv frontend and the vision tower.
"""

from __future__ import annotations

import numpy as np

from repro_torch.configs.base import text_len


class SyntheticDataset:
    def __init__(self, cfg, *, seq_len: int, global_batch: int,
                 seed: int = 0, process_index: int = 0,
                 process_count: int = 1):
        if global_batch % process_count:
            raise ValueError(f"global batch {global_batch} does not split "
                             f"over {process_count} processes")
        self.cfg = cfg
        self.seq_len = seq_len
        self.local_batch = global_batch // process_count
        self.seed = seed
        self.process_index = process_index

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.seed * 1_000_003 + step) * 4096 + self.process_index)

    def batch(self, step: int) -> dict:
        """Step ``step``'s local batch: numpy tokens/labels int32 [b, t]
        (and frames [b, seq_len, d] or patches [b, n_img, d], f32)."""
        cfg = self.cfg
        rng = self._rng(step)
        b = self.local_batch
        t = text_len(cfg, self.seq_len, "train")
        base = rng.zipf(1.3, size=(b, t + 1)) % cfg.vocab
        succ = (np.arange(cfg.vocab) * 31 + 7) % cfg.vocab
        mask = rng.random((b, t)) < 0.5
        base[:, 1:][mask] = succ[base[:, :-1][mask]]
        out = {"tokens": base[:, :t].astype(np.int32),
               "labels": base[:, 1:].astype(np.int32)}
        if cfg.family == "encdec":
            out["frames"] = rng.standard_normal(
                (b, self.seq_len, cfg.d_model)).astype(np.float32) * 0.02
        if cfg.family == "vlm":
            out["patches"] = rng.standard_normal(
                (b, cfg.n_img_tokens, cfg.d_model)).astype(np.float32) * 0.02
        return out
