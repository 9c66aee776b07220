"""qwen1.5-110b [dense] — 80 layers, d 8192, 64 heads of 128 over 8 KV
heads, QKV bias [hf:Qwen/Qwen1.5-110B]."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab=152064,
    head_dim=128,
    qkv_bias=True,
))

REDUCED = register(CONFIG.replace(
    name="qwen1.5-110b-reduced", n_layers=3, d_model=128, n_heads=4,
    n_kv_heads=2, d_ff=256, vocab=512, head_dim=32, lop_block=32))
