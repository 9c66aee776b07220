"""Roofline terms and the card's published limits (NVIDIA H100 SXM).

    compute term    = FLOPs      / peak FLOP/s
    memory term     = bytes      / HBM bandwidth
    collective term = coll_bytes / NVLink bandwidth (one direction)

The constants below are the data sheet's figures for one H100 SXM card
at its full 700 W power limit, dense rates without sparsity. They are
spec numbers, not measurements: a card set below 700 W runs slower under
load, so a roofline share names the card's power limit beside it. Every
bound the port reports (``chip_smoke.py``'s ``bound_ms``, the tile sweep
of :mod:`repro_torch.kernels.autotune`, the decode kernels' shared-memory
limit) is computed from these, and no other copy of them exists.
"""

from __future__ import annotations

import math

from repro_torch.tree_util import flatten_with_path, leaves

HBM_BW = 3.35e12                  # B/s, HBM3
PEAK_OPS_INT8 = 1979e12           # dense int8 tensor-core OP/s
PEAK_FLOPS_BF16 = 989e12          # dense bf16 tensor-core FLOP/s
PEAK_FLOPS_F32 = 67e12            # f32 outside the tensor cores
NVLINK_BW = 450e9                 # B/s a direction, to the other cards
SMS = 132                         # streaming multiprocessors
SMEM_PER_SM = 228 * 1024          # shared memory an SM holds for its CTAs
SMEM_PER_CTA = 232448             # bytes one CTA may opt into
SMEM_RESERVED_PER_CTA = 1024      # the system's share of each resident CTA
THREADS_PER_SM = 2048
CTAS_PER_SM = 32
REGS_PER_SM = 65536               # 32-bit registers
REG_ALLOC_UNIT = 256              # registers a warp is granted at a time


def smem_budget() -> int:
    """Bytes of shared memory one CTA may claim (the tile sweep's bound)."""
    return SMEM_PER_CTA


def resident_ctas_per_sm(threads: int, smem: int, regs: int = 0) -> int:
    """CTAs of ``threads`` threads, ``smem`` dynamic shared-memory bytes
    and ``regs`` registers a thread (0: not counted) one SM holds at once,
    by the static limits: threads, CTA slots, shared memory, registers
    (granted a warp at a time in units of 256). 0 = the CTA cannot run."""
    if smem > SMEM_PER_CTA or threads > 1024 or threads < 1 or regs > 255:
        return 0
    fit = min(CTAS_PER_SM, THREADS_PER_SM // threads,
              SMEM_PER_SM // (smem + SMEM_RESERVED_PER_CTA))
    if regs:
        per_warp = -(-regs * 32 // REG_ALLOC_UNIT) * REG_ALLOC_UNIT
        fit = min(fit, REGS_PER_SM // (per_warp * -(-threads // 32)))
    return fit


def arithmetic_intensity(flops: float, bytes_accessed: float) -> float:
    """Operations per HBM byte — the roofline x-axis."""
    return flops / bytes_accessed if bytes_accessed > 0 else 0.0


def machine_balance(int8: bool = False) -> float:
    """The roofline ridge point (operations/byte): work whose arithmetic
    intensity sits below it is HBM-bound however it is scheduled."""
    peak = PEAK_OPS_INT8 if int8 else PEAK_FLOPS_BF16
    return peak / HBM_BW


def roofline_terms(cost: dict, coll: dict, *, model_flops_per_chip: float
                   = 0.0) -> dict:
    """cost: ``{"flops", "bytes accessed"}``; coll: ``{"total"}`` bytes a
    card sends over NVLink. → the three terms, the dominant one and, with
    ``model_flops_per_chip``, the useful and roofline fractions."""
    flops = float(cost.get("flops", 0.0))
    bytes_accessed = float(cost.get("bytes accessed", 0.0))
    coll_bytes = float(coll.get("total", 0.0))
    terms = {
        "hlo_flops": flops,
        "hlo_bytes": bytes_accessed,
        "collective_bytes": coll_bytes,
        "compute_s": flops / PEAK_FLOPS_BF16,
        "compute_s_int8": flops / PEAK_OPS_INT8,
        "memory_s": bytes_accessed / HBM_BW,
        "collective_s": coll_bytes / NVLINK_BW,
    }
    dominant = max(("compute_s", "memory_s", "collective_s"),
                   key=lambda k: terms[k])
    terms["dominant"] = dominant
    terms["bound_s"] = terms[dominant]
    if model_flops_per_chip:
        terms["model_flops"] = model_flops_per_chip
        terms["useful_fraction"] = (model_flops_per_chip / flops
                                    if flops else 0.0)
        if terms["bound_s"] > 0:
            terms["roofline_fraction"] = (
                model_flops_per_chip / terms["bound_s"] / PEAK_FLOPS_BF16)
    return terms


def count_params(tree) -> int:
    """Elements of every leaf (tensor or array) of a nested tree."""
    return int(sum(math.prod(x.shape) for x in leaves(tree)))


def model_flops(cfg, shape, n_params: int, n_active: int) -> float:
    """Analytic model FLOPs of a cell (global, all cards).

    train: 6·N_active·D tokens; prefill: 2·N_active·D; decode:
    2·N_active·B (one token a sequence).
    """
    from repro_torch.configs.base import text_len
    if shape.kind == "train":
        d = shape.global_batch * text_len(cfg, shape.seq_len, "train")
        return 6.0 * n_active * d
    if shape.kind == "prefill":
        d = shape.global_batch * text_len(cfg, shape.seq_len, "prefill")
        return 2.0 * n_active * d
    return 2.0 * n_active * shape.global_batch


_EXPERT_LEAVES = ("w_gate", "w_up", "w_down", "gu_packed", "gu_scale",
                  "down_packed", "down_scale")


def active_params(cfg, n_params: int, params_tree=None) -> int:
    """N_active: MoE expert parameters scaled by top_k / E."""
    if cfg.n_experts == 0 or params_tree is None:
        return n_params
    expert = sum(math.prod(leaf.shape)
                 for path, leaf in flatten_with_path(params_tree)
                 if "moe" in path and any(n in path for n in _EXPERT_LEAVES))
    dense = n_params - expert
    return int(dense + expert * cfg.top_k / cfg.n_experts)
