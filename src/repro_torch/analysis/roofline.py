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
limit, the dry-run's ``fits``) is computed from these, and no other
copy of them exists. :func:`kernel_cost` counts what such a bound
counts for each kernel of the table: its inputs read once, its output
written once, and its operations.
"""

from __future__ import annotations

import math

from repro_torch.tree_util import flatten_with_path, leaves

HBM_BW = 3.35e12                  # B/s, HBM3
HBM_BYTES = 80 * 10**9            # device memory, the data sheet's 80 GB
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


# ---------------------------------------------------------------------------
# the kernels' work
# ---------------------------------------------------------------------------

def _cost(nbytes: int, int8_ops: int = 0, flops: int = 0) -> dict:
    return {"bytes": int(nbytes), "int8_ops": int(int8_ops),
            "flops": int(flops)}


def _causal_pairs(rows: int, q_off: int, window: int) -> int:
    """Query-key pairs rows [q_off, q_off + rows) see causally (within
    ``window`` keys when it is set)."""
    if not window:
        return rows * q_off + rows * (rows + 1) // 2
    return sum(min(q_off + i + 1, window) for i in range(rows))


def _decode_live(new_len, k_keep: int, block: int) -> tuple:
    """(Σ tokens, blocks the selection gathers, tokens those blocks
    hold) over the lanes' ``new_len`` (an int: every lane's)."""
    total = sel = live = 0
    for n in new_len:
        if n > 0:
            total += n
            sel += min(k_keep, -(-n // block))
            live += min(n, k_keep * block)
    return total, sel, live


def kernel_cost(name: str, **dims) -> dict:
    """Bytes, int8 operations and f32 FLOPs (integers) of one launch of kernel
    ``name`` (a key of :data:`repro_torch.kernels.ops.KERNELS`), as a
    bound counts them: every input read once, the output written once
    (the kernels' scratch is not counted), and the work this launch's
    data needs — the decode kernels' live tokens.

    ``fused_qlinear``: m, k, n (bias). ``fused_ffn``: m, k, f, n (gated).
    Their ``_experts`` forms: the same and e. ``fused_prefill_attention``:
    b, h, hkv, c (query rows a head), dh, kvl (keys attended), q_off,
    causal, window. ``fused_decode_attention`` /
    ``fused_dense_decode_attention``: b, h, hkv, dh, block, new_len (a
    lane's live rows, a list of B; LOP also k_keep), return_stats.
    ``ternary_matmul``: m, k, n. ``lop_scores_kernel``: lanes, r, m, d.
    ``int8_flash_prefill``: s, d, causal, window.
    ``sparse_decode_attention``: lanes, g, d, nb, live (tokens the gates
    open over every lane)."""
    d = dims
    if name in ("fused_qlinear", "fused_qlinear_experts"):
        e, m, k, n = d.get("e", 1), d["m"], d["k"], d["n"]
        per = m * k * 4 + (k // 4) * n + n * 4 + m * n * 4
        if d.get("bias"):
            per += n * 4
        return _cost(e * per, e * 2 * m * k * n)
    if name in ("fused_ffn", "fused_ffn_experts"):
        e, m, k, f, n = d.get("e", 1), d["m"], d["k"], d["f"], d["n"]
        gu = 2 * f if d.get("gated", True) else f
        per = (m * k * 4 + (k // 4) * gu + gu * 4 + (f // 4) * n + n * 4
               + m * n * 4)
        return _cost(e * per, e * (2 * m * k * gu + 2 * m * f * n))
    if name == "fused_prefill_attention":
        b, h, hkv, c, dh = d["b"], d["h"], d["hkv"], d["c"], d["dh"]
        kvl = d["kvl"]
        pairs = (_causal_pairs(c, d.get("q_off", 0), d.get("window", 0))
                 if d.get("causal", True) else c * kvl)
        nbytes = (b * h * c * (dh + 4) + b * hkv * kvl * (2 * dh + 8)
                  + b * h * c * dh * 4)
        ops = 2 * b * h * pairs * dh
        return _cost(nbytes, ops, ops)
    if name in ("fused_decode_attention", "fused_dense_decode_attention"):
        b, h, hkv, dh, block = d["b"], d["h"], d["hkv"], d["dh"], d["block"]
        lop = name == "fused_decode_attention"
        total, sel, live = _decode_live(d["new_len"], d.get("k_keep", 0),
                                        block)
        nbytes = b * h * dh + b * h * 4 + b * 4 + b * h * dh * 4
        if d.get("return_stats"):
            nbytes += 2 * b * h * 4
        if lop:
            nbytes += hkv * total * (dh // 2) + hkv * sel * block * (
                2 * dh + 8)
            return _cost(nbytes, 2 * h * (total + live) * dh,
                         2 * h * live * dh)
        nbytes += hkv * total * (2 * dh + 8)
        return _cost(nbytes, 2 * h * total * dh, 2 * h * total * dh)
    if name == "ternary_matmul":
        m, k, n = d["m"], d["k"], d["n"]
        return _cost(m * k + (k // 4) * n + m * n * 4, 2 * m * k * n)
    if name == "lop_scores_kernel":
        lanes, r, m, dd = d["lanes"], d["r"], d["m"], d["d"]
        return _cost(lanes * r * dd + lanes * m * (dd // 2)
                     + lanes * r * m * 4, 2 * lanes * r * m * dd)
    if name == "int8_flash_prefill":
        s, dd = d["s"], d["d"]
        pairs = (_causal_pairs(s, 0, d.get("window", 0))
                 if d.get("causal", True) else s * s)
        ops = 2 * pairs * dd
        return _cost(3 * s * dd + 3 * s * 4 + s * dd * 4, ops, ops)
    if name == "sparse_decode_attention":
        lanes, g, dd, nb, live = (d["lanes"], d["g"], d["d"], d["nb"],
                                  d["live"])
        ops = 2 * g * live * dd
        return _cost(lanes * g * (dd + 4) + lanes * 4 * nb * 4
                     + live * (2 * dd + 8) + lanes * g * dd * 4, ops, ops)
    raise KeyError(f"no cost model for kernel {name!r}")
