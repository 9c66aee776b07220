"""mixtral-8x22b [moe] — 8 experts top-2, sliding window 4096
[hf:mistralai/Mixtral-8x22B-v0.1]. Its f32 master tree (about 141 G
parameters, 564 GB) does not fit one card, so only the reduced variant
runs here."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=32768,
    head_dim=128,
    n_experts=8,
    top_k=2,
    swa_window=4096,
    rope_theta=1_000_000.0,
))

REDUCED = register(CONFIG.replace(
    name="mixtral-8x22b-reduced", n_layers=4, d_model=128, n_heads=4,
    n_kv_heads=2, d_ff=256, vocab=512, head_dim=32, n_experts=4, top_k=2,
    swa_window=64, moe_group=64, lop_block=32))
