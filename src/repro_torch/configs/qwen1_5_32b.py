"""qwen1.5-32b [dense] — 64 layers, d 5120, 40 heads of 128, QKV bias
[hf:Qwen/Qwen1.5-32B]."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab=152064,
    head_dim=128,
    qkv_bias=True,
))

REDUCED = register(CONFIG.replace(
    name="qwen1.5-32b-reduced", n_layers=3, d_model=128, n_heads=4,
    n_kv_heads=4, d_ff=256, vocab=512, head_dim=32, lop_block=32))
