"""stablelm-1.6b [dense] — 24 layers, d 2048, 32 heads of 64, LayerNorm
[hf:stabilityai/stablelm-2-1_6b]."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab=100352,
    head_dim=64,
    norm="layernorm",
))

REDUCED = register(CONFIG.replace(
    name="stablelm-1.6b-reduced", n_layers=3, d_model=96, n_heads=4,
    n_kv_heads=4, d_ff=192, vocab=512, head_dim=24, lop_block=32))
