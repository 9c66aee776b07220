"""rwkv6-1.6b [ssm] — attention-free RWKV6, 24 layers, d 2048
[hf:RWKV/v6-Finch-1B6-HF]. LOP has no K/V cache to screen here
(``use_lop=False``); the family's cache is each layer's recurrent
state."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=7168,
    vocab=65536,
    head_dim=64,
    use_lop=False,
))

REDUCED = register(CONFIG.replace(
    name="rwkv6-1.6b-reduced", n_layers=3, d_model=96, n_heads=4,
    n_kv_heads=4, d_ff=192, vocab=512, head_dim=24))
