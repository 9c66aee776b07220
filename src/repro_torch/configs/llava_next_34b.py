"""llava-next-34b [vlm] — the decoder backbone with a stub patch-embedding
prefix of 2880 anyres tokens [hf:llava-hf/llava-v1.6-mistral-7b-hf]. A
request's patch rows go through the f32 projector and ride its first
prefill chunk (``serving/engine.py``)."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    head_dim=128,
    n_img_tokens=2880,
    rope_theta=5_000_000.0,
))

REDUCED = register(CONFIG.replace(
    name="llava-next-34b-reduced", n_layers=3, d_model=128, n_heads=4,
    n_kv_heads=2, d_ff=256, vocab=512, head_dim=32, n_img_tokens=16,
    lop_block=32))
