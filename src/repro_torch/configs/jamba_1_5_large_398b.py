"""jamba-1.5-large-398b [hybrid] — Mamba + attention 1:7, MoE 16 top-2
every other layer [arXiv:2403.19887]. Served reduced; the full width
(about 100 GB even packed) does not fit one card."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    head_dim=128,
    n_experts=16,
    top_k=2,
    attn_every=8,
    moe_every=2,
    mamba_d_state=16,
    mamba_expand=2,
    mamba_conv=4,
))

REDUCED = register(CONFIG.replace(
    name="jamba-1.5-large-398b-reduced", n_layers=8, d_model=128, n_heads=4,
    n_kv_heads=2, d_ff=256, vocab=512, head_dim=32, n_experts=4, top_k=2,
    attn_every=4, moe_every=2, moe_group=64, lop_block=32))
