"""granite-moe-1b-a400m [moe] — 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base].

24 layers, d 1024, 16 heads of 64 over 8 KV heads, expert FFN d_ff 512,
vocab 49155. ``granite-moe-1b-a400m-reduced`` is the 3-layer, d 96,
8-expert top-4 variant the tests run on the CPU.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    head_dim=64,
    n_experts=32,
    top_k=8,
))

REDUCED = register(CONFIG.replace(
    name="granite-moe-1b-a400m-reduced", n_layers=3, d_model=96, n_heads=4,
    n_kv_heads=2, d_ff=64, vocab=512, head_dim=24, n_experts=8, top_k=4,
    moe_group=64, lop_block=32))
