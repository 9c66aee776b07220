"""Leading-One Prediction (LOP) predictive sparse attention — paper §III-A.

The surrogate score ``ŝ(q, k) = Σ sgn(qᵢ)sgn(kᵢ)·2^(LO(qᵢ)+LO(kᵢ))`` is the
dot product of power-of-two-rounded vectors ``pot(x) = sgn(x)·2^LO(|x|)``;
keys are cached as 4-bit (sgn‖LO) nibbles, two per byte. Selection is the
comparison-free bucketized top-K: scores fall into 64 linear buckets, the
cut bucket is where the high-to-low cumulative count first reaches K, and
ranks are emitted in index order above and at the cut.
"""

from __future__ import annotations

import torch

from repro_torch.core.quantization import int_matmul

# LO field values 0..6 encode ⌊log₂|x|⌋ for |x| ∈ [1,127]; 7 encodes x == 0.
LO_ZERO = 7
DEFAULT_N_BUCKETS = 64


def leading_one(x: torch.Tensor) -> torch.Tensor:
    """⌊log₂|x|⌋ for int8 magnitudes, exactly; x == 0 → LO_ZERO."""
    v = x.to(torch.int32).abs()
    lo = sum((v >= t).to(torch.int32) for t in (2, 4, 8, 16, 32, 64))
    return torch.where(v == 0, LO_ZERO, lo).to(torch.int32)


def _mag(lo: torch.Tensor) -> torch.Tensor:
    return torch.where(lo == LO_ZERO, 0,
                       torch.bitwise_left_shift(torch.ones_like(lo),
                                                lo.clamp_max(6)))


def pot(x: torch.Tensor) -> torch.Tensor:
    """sgn(x)·2^LO(|x|) as int8 (0 stays 0, max ±64)."""
    return (torch.sign(x.to(torch.int32)) * _mag(leading_one(x))).to(
        torch.int8)


def lop_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Surrogate scores ŝ = pot(q)·pot(k)ᵀ in int32, exactly.
    q [..., d], k [..., M, d] → [..., M]."""
    return int_matmul(pot(q)[..., None, :], pot(k).transpose(-1, -2))[
        ..., 0, :]


def lop_features(x: torch.Tensor) -> torch.Tensor:
    """Per-element nibble (sgn_bit << 3) | LO as uint8."""
    sgn = (x < 0).to(torch.int32)
    return ((sgn << 3) | leading_one(x)).to(torch.uint8)


def features_to_pot(feat: torch.Tensor) -> torch.Tensor:
    """Nibbles → pot() int8 values."""
    lo = (feat & 0x7).to(torch.int32)
    sgn = ((feat >> 3) & 0x1).to(torch.int32)
    return ((1 - 2 * sgn) * _mag(lo)).to(torch.int8)


def pack_features(feat: torch.Tensor) -> torch.Tensor:
    """Nibbles [..., d] (d even) → uint8 [..., d//2]; even elements low."""
    return (feat[..., 0::2] | (feat[..., 1::2] << 4)).to(torch.uint8)


def unpack_features(packed: torch.Tensor) -> torch.Tensor:
    """uint8 [..., d//2] → nibbles [..., d]."""
    lo = packed & 0xF
    hi = (packed >> 4) & 0xF
    return torch.stack([lo, hi], dim=-1).reshape(
        *packed.shape[:-1], packed.shape[-1] * 2).to(torch.uint8)


def comparison_free_rank(s: torch.Tensor, k: int,
                         n_buckets: int = DEFAULT_N_BUCKETS) -> torch.Tensor:
    """Emission ranks of the bucketized selector: f32 [R, M] → int32 [R, M].

    Non-finite scores are invalid and never selected. ``rank < k`` means
    selected; every other entry gets the sentinel ``M + k + 1``. The float
    steps keep the reference's order, ``((s − smin) / span) · n_buckets``
    truncated toward zero, so the buckets (and the ranks) are bitwise.
    """
    m = s.shape[-1]
    finite = torch.isfinite(s)
    inf = torch.tensor(float("inf"), dtype=s.dtype, device=s.device)
    smin = torch.where(finite, s, inf).amin(-1, keepdim=True)
    smax = torch.where(finite, s, -inf).amax(-1, keepdim=True)
    span = torch.clamp_min(smax - smin, 1e-9)
    ratio = torch.where(finite, (s - smin) / span * n_buckets,
                        torch.zeros_like(s))
    bucket = ratio.to(torch.int32).clamp(0, n_buckets - 1)
    bucket = torch.where(finite, bucket, -1)

    bins = torch.arange(n_buckets, device=s.device, dtype=torch.int32)
    cnt_ge = (bucket[..., None] >= bins).sum(-2, dtype=torch.int32)
    reach = cnt_ge >= k
    cut = torch.where(reach.any(-1, keepdim=True),
                      torch.where(reach, bins, -1).amax(-1, keepdim=True),
                      torch.zeros_like(cnt_ge[..., :1]))
    above = bucket > cut
    at_cut = bucket == cut
    n_above = above.sum(-1, keepdim=True, dtype=torch.int32)
    rank_above = torch.cumsum(above.to(torch.int32), -1) - 1
    rank_cut = n_above + torch.cumsum(at_cut.to(torch.int32), -1) - 1
    big = m + k + 1
    rank = torch.where(above, rank_above,
                       torch.where(at_cut, rank_cut, big))
    return torch.where(rank < k, rank, big).to(torch.int32)


def comparison_free_topk(scores: torch.Tensor, k: int,
                         n_buckets: int = DEFAULT_N_BUCKETS,
                         valid: torch.Tensor | None = None):
    """Top-k of ``scores`` [..., M] without pairwise compares.

    → (indices [..., k] int32, gate [..., k] bool); unfilled slots hold
    index 0 with gate False.
    """
    lead, m = scores.shape[:-1], scores.shape[-1]
    s = scores.to(torch.float32).reshape(-1, m)
    if valid is not None:
        s = torch.where(valid.reshape(-1, m), s, float("-inf"))
    rank = comparison_free_rank(s, k, n_buckets)
    sel = rank < k
    out = torch.zeros((s.shape[0], k + 1), dtype=torch.int32,
                      device=s.device)
    cols = torch.arange(m, dtype=torch.int32, device=s.device).expand_as(rank)
    out.scatter_(1, torch.where(sel, rank, k).to(torch.int64), cols)
    n_sel = sel.sum(-1, keepdim=True).clamp_max(k)
    gate = torch.arange(k, device=s.device) < n_sel
    return out[:, :k].reshape(*lead, k), gate.reshape(*lead, k)


def block_reduce_scores(scores: torch.Tensor, block: int,
                        mode: str = "max") -> torch.Tensor:
    """Token scores [..., M] → block scores [..., M//block]."""
    *lead, m = scores.shape
    if m % block:
        raise ValueError(f"M={m} not a multiple of block={block}")
    s = scores.reshape(*lead, m // block, block)
    return s.amax(-1) if mode == "max" else s.sum(-1)


def exact_topk(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Comparator-based top-k indices (int32), ties to the lower index —
    the oracle for recall tests."""
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    return order[..., :k].to(torch.int32)


def kv_traffic_bytes(m: int, d: int, k: int, *, packed_features: bool = True,
                     with_lop: bool = True) -> int:
    """K/V bytes fetched per (head, query): all M int8 keys and values
    without LOP; with LOP the feature cache (d/2 bytes a key when packed)
    plus K exact keys and values."""
    if not with_lop:
        return 2 * m * d
    feat = m * (d // 2 if packed_features else d)
    return feat + 2 * k * d
