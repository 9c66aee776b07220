"""Batched token sampling for the serving stack, bit-compatible with the
reference's ``jax.random`` key schedule.

The contract (the reference's ``serving/sampling.py``):

  * **Greedy fast path.** ``temperature <= 0`` lanes return
    ``argmax(logits)`` (first maximal index).
  * **Lane-local PRNG schedule.** The key for a request's *i*-th generated
    token (the prefill-seeded first token is i = 0) is
    ``fold_in(PRNGKey(seed), i)`` — a function of the request's own seed
    and emission count only, so a seeded request draws the same tokens
    alone or in the pool.
  * **Row-local math.** Every op reduces over the vocab axis of its own
    row.

Filtering: temperature scales the logits, then top-k and top-p restrict
the support (ties at the cutoff are kept, ``>=``), then one categorical
draw by the Gumbel-max trick.

The random bits are JAX's own: threefry2x32 (20 rounds), ``PRNGKey(s)`` =
``(0, s)`` for a 32-bit seed, ``fold_in(k, d)`` = ``threefry(k, (0, d))``,
and 32-bit ``random_bits`` over shape (V,) from the partitionable path
(``jax_threefry_partitionable``): ``hi ^ lo`` of threefry over the 64-bit
iota, whose high words are 0 here. ``uniform`` is ``(bits >> 9) |
0x3F800000`` as f32, minus 1, ``·(max − min) + min``, then ``max(min, ·)``;
the Gumbel noise is the "low" mode, ``−log(−log(uniform(tiny, 1)))``.
PyTorch's ``uint32`` lacks most ops, so the words are int64 tensors
masked to 32 bits. The sampler is plain PyTorch on the card.
"""

from __future__ import annotations

import torch

# temperatures at or below this sample greedily (exact argmax)
GREEDY_EPS = 0.0

_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = torch.finfo(torch.float32).tiny


def _u32(x) -> torch.Tensor:
    """Any integer tensor → int64 holding its value modulo 2**32."""
    return x.to(torch.int64) & _MASK32


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & _MASK32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the count words (x1, x2)
    under the key words (k1, k2); broadcasting int64 tensors holding
    32-bit values. → (y1, y2)."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & _MASK32
    b = (x2 + ks[1]) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _MASK32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _MASK32
        b = (b + ks[(i + 2) % 3] + i + 1) & _MASK32
    return a, b


def prng_key(seed) -> torch.Tensor:
    """``jax.random.PRNGKey`` of 32-bit seeds: int64 [..., 2] = (0, seed)."""
    seed = _u32(torch.as_tensor(seed))
    return torch.stack([torch.zeros_like(seed), seed], dim=-1)


def fold_in(key, data) -> torch.Tensor:
    """``jax.random.fold_in``: key [..., 2], data (broadcastable) → key."""
    data = _u32(torch.as_tensor(data, device=key.device))
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack([y1, y2], dim=-1)


def random_bits(keys, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` per key: keys [..., 2] →
    int64 [..., n] holding the 32-bit words."""
    lo = torch.arange(n, dtype=torch.int64, device=keys.device)
    y1, y2 = threefry2x32(keys[..., 0:1], keys[..., 1:2],
                          torch.zeros_like(lo), lo)
    return y1 ^ y2


def uniform(keys, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)`` per key
    → f32 [..., n]."""
    bits = random_bits(keys, n)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    floats = floats - 1.0
    # filled on the device: no host-to-device copy, which a CUDA graph's
    # capture forbids
    lo = torch.full((), minval, dtype=torch.float32, device=keys.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=keys.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(keys, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32, mode="low")`` per key."""
    return -torch.log(-torch.log(uniform(keys, n, _F32_TINY, 1.0)))


def categorical(keys, logits) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` per row: keys [B, 2],
    logits f32 [B, V] → int64 [B]."""
    return torch.argmax(gumbel(keys, logits.shape[-1]) + logits, dim=-1)


def lane_keys(seeds, steps) -> torch.Tensor:
    """Per-lane keys [B, 2] = ``fold_in(PRNGKey(seed), step)``; seeds and
    steps are taken modulo 2**32, as ``astype(uint32)`` does."""
    return fold_in(prng_key(seeds), steps)


def _mask_top_k(logits, top_k):
    """Keep each row's k largest logits (k <= 0 disables); ties at the
    k-th largest value are kept."""
    v = logits.shape[-1]
    desc = torch.sort(logits, dim=-1, descending=True).values
    kk = torch.clamp(top_k, 1, v).to(torch.int64)
    thresh = torch.gather(desc, -1, kk[:, None] - 1)
    keep = (logits >= thresh) | (top_k[:, None] <= 0)
    return torch.where(keep, logits, -torch.inf)


def _mask_top_p(logits, top_p):
    """Nucleus filter: a token is kept iff the sorted mass strictly before
    it is < p (p clamped away from 0; p >= 1 disables), so the crossing
    token survives and the support is never empty."""
    desc = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(desc, dim=-1)
    before = torch.cumsum(probs, dim=-1) - probs
    keep_desc = before < torch.clamp_min(top_p, 1e-9)[:, None]
    cutoff = torch.where(keep_desc, desc, torch.inf).amin(-1, keepdim=True)
    keep = (logits >= cutoff) | (top_p[:, None] >= 1.0)
    return torch.where(keep, logits, -torch.inf)


def sample_tokens(logits, keys, temperature, top_k, top_p) -> torch.Tensor:
    """Batched per-lane sampling → int32 [B].

    logits f32 [B, V]; keys [B, 2] (:func:`lane_keys`); temperature f32
    [B] (<= 0 → greedy argmax); top_k int [B] (<= 0 → off); top_p f32 [B]
    (>= 1 → off). Lanes are independent rows.
    """
    logits = logits.to(torch.float32)
    greedy = torch.argmax(logits, dim=-1)
    # divide by a tensor: the IEEE quotient on every device
    scaled = logits / torch.clamp_min(temperature, 1e-6)[:, None]
    scaled = _mask_top_k(scaled, top_k)
    scaled = _mask_top_p(scaled, top_p)
    drawn = categorical(keys, scaled)
    return torch.where(temperature > GREEDY_EPS, drawn, greedy).to(
        torch.int32)


def sample_with_seed(logits, seeds, steps, temperature, top_k,
                     top_p) -> torch.Tensor:
    """:func:`sample_tokens` with the key schedule applied — the one entry
    both the decode step and the first-token sample go through."""
    return sample_tokens(logits, lane_keys(seeds, steps), temperature,
                         top_k, top_p)
