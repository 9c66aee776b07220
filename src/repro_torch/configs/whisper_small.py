"""whisper-small [encdec] — the backbone: 12 encoder and 12 decoder
layers, d 768, gelu MLP, rotary positions, a stub frame frontend
[arXiv:2212.04356]. Each request carries its encoder frames."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,
    n_encoder_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    head_dim=64,
    norm="layernorm",
    gated_ffn=False,
    cross_ctx=1500,
))

REDUCED = register(CONFIG.replace(
    name="whisper-small-reduced", n_layers=2, n_encoder_layers=2, d_model=96,
    n_heads=4, n_kv_heads=4, d_ff=192, vocab=512, head_dim=24, cross_ctx=64,
    lop_block=32))
