"""mistral-nemo-12b [dense] — 40 layers, d 5120, 32 heads of 128 over 8 KV
heads (q_dim 4096 ≠ d_model) [hf:mistralai/Mistral-Nemo-Base-2407]."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=131072,
    head_dim=128,
    rope_theta=1_000_000.0,
))

REDUCED = register(CONFIG.replace(
    name="mistral-nemo-12b-reduced", n_layers=3, d_model=128, n_heads=4,
    n_kv_heads=2, d_ff=256, vocab=512, head_dim=32, lop_block=32))
