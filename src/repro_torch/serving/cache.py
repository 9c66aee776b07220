"""Serving caches: int8 K/V + absmax scales + packed LOP features.

The cache is a dict of tensors: ``lengths`` int32 [B] and, per layer-stacked
leaf, ``layers.k``/``layers.v`` int8 [L, B, Hkv, M, dh], ``k_scale``/
``v_scale`` f32 [L, B, Hkv, M] and ``feat`` uint8 [L, B, Hkv, M, dh//2].
Capacity M is block-aligned (``lop_block``). A slot-paged pool adds an
``active`` bool [B] mask and each lane's sampling state, ``seed`` and
``sample_step`` int32 [B] (the PRNG schedule travels with the lane).

Unlike the reference's functional updates, these operations write the
pool in place: ``insert_slot`` copies a batch-1 cache into a lane,
``extract_slot`` returns *views* of a lane (so a chunked-prefill step that
writes its chunk into the extracted lane writes the pool itself), and
``evict_slot`` retires a lane and ``rollback_slot`` rewinds one. Bytes
above a lane's length are stale and masked by every reader.
"""

from __future__ import annotations

import torch

_LEAVES = ("k", "v", "k_scale", "v_scale", "feat")


def round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def capacity_for(cfg, max_len: int) -> int:
    """Token capacity for ``max_len`` tokens plus one decode slot."""
    return round_up(max_len + 1, cfg.lop_block)


def init_cache(cfg, batch: int, max_len: int, device) -> dict:
    """Zero cache for ``batch`` sequences of up to ``max_len`` tokens."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    cap = capacity_for(cfg, max_len)
    lead = (cfg.n_layers, batch, cfg.n_kv_heads, cap)
    dh = cfg.hd
    layers = {
        "k": torch.zeros((*lead, dh), dtype=torch.int8, device=device),
        "v": torch.zeros((*lead, dh), dtype=torch.int8, device=device),
        "k_scale": torch.zeros(lead, dtype=torch.float32, device=device),
        "v_scale": torch.zeros(lead, dtype=torch.float32, device=device),
        "feat": torch.zeros((*lead, dh // 2), dtype=torch.uint8,
                            device=device),
    }
    return {"lengths": torch.zeros(batch, dtype=torch.int32, device=device),
            "layers": layers}


def init_cache_pool(cfg, n_slots: int, max_len: int, device) -> dict:
    """Slot-paged pool: ``n_slots`` persistent decode lanes, all inactive."""
    pool = init_cache(cfg, n_slots, max_len, device)
    pool["active"] = torch.zeros(n_slots, dtype=torch.bool, device=device)
    pool["seed"] = torch.zeros(n_slots, dtype=torch.int32, device=device)
    pool["sample_step"] = torch.zeros(n_slots, dtype=torch.int32,
                                      device=device)
    return pool


def pool_capacity(pool) -> int:
    return pool["layers"]["k"].shape[3]


def insert_slot(pool, slot: int, req_cache, active: bool = True) -> dict:
    """Copy a batch-1 cache into lane ``slot`` (in place).

    The request cache's capacity may be smaller than the pool's; positions
    above it keep stale bytes, masked by ``lengths``. Copying a lane onto
    itself (an ``extract_slot`` view) is skipped.
    """
    for key in _LEAVES:
        dst = pool["layers"][key][:, slot]
        src = req_cache["layers"][key][:, 0]
        if dst.data_ptr() != src.data_ptr():
            dst[:, :, :src.shape[2]].copy_(src)
    pool["lengths"][slot] = req_cache["lengths"][0]
    pool["active"][slot] = active
    return pool


def extract_slot(pool, slot: int) -> dict:
    """Batch-1 *views* of lane ``slot``: writes through them land in the
    pool (chunked prefill writes its chunk's K/V this way)."""
    return {"lengths": pool["lengths"][slot:slot + 1],
            "layers": {key: pool["layers"][key][:, slot:slot + 1]
                       for key in _LEAVES}}


def evict_slot(pool, slot: int) -> dict:
    """Retire lane ``slot`` (in place): inactive, length 0, and its packed
    LOP feature rows zeroed (the pool-init bit pattern)."""
    pool["layers"]["feat"][:, slot].zero_()
    pool["active"][slot] = False
    pool["lengths"][slot] = 0
    return pool


def rollback_slot(pool, slot: int, n: int) -> dict:
    """Rewind lane ``slot`` by ``n`` appended tokens (in place).

    ``lengths`` drops by ``n`` (clamped at 0) and the rows
    ``[lengths − n, lengths)`` of k/v/k_scale/v_scale/feat are zeroed, so
    the lane is bit for bit its pool-init pattern there; ``sample_step``
    rewinds by ``n`` too (clamped at 0), keeping a sampled lane's key
    schedule aligned with its emission count.
    """
    old = int(pool["lengths"][slot])
    new = max(old - n, 0)
    for key in _LEAVES:
        pool["layers"][key][:, slot, :, new:old].zero_()
    pool["lengths"][slot] = new
    if "sample_step" in pool:
        pool["sample_step"][slot] = torch.clamp_min(
            pool["sample_step"][slot] - n, 0)
    return pool
