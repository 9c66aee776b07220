"""bitnet-3b — the paper's own model: BitNet b1.58 3B [arXiv:2402.17764].

LLaMA-3B-shaped (26 layers, d 3200, 32 heads of 100, ffn 8640) with every
projection a BitLinear. ``bitnet-3b-reduced`` is the 3-layer, d 128 variant
the tests run on the CPU.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="bitnet-3b",
    family="dense",
    n_layers=26,
    d_model=3200,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8640,
    vocab=32000,
    head_dim=100,
))

REDUCED = register(CONFIG.replace(
    name="bitnet-3b-reduced", n_layers=3, d_model=128, n_heads=4,
    n_kv_heads=4, d_ff=256, vocab=512, head_dim=32, lop_block=32))
