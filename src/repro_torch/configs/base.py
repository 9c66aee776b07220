"""Model configuration: every architecture is a ``ModelConfig``.

A jax-free copy of the reference's config record (same fields, same
derived properties). Only the dense family is served by this package so
far; the other families' fields are kept so configs compare field for
field with the reference.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 → d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_group: int = 2048
    # --- attention extras ---
    swa_window: int = 0         # 0 = full attention
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    # --- hybrid (Jamba) ---
    attn_every: int = 0
    moe_every: int = 0
    mamba_d_state: int = 16
    mamba_expand: int = 2
    mamba_conv: int = 4
    # --- encdec (Whisper) ---
    n_encoder_layers: int = 0
    cross_ctx: int = 1500
    # --- vlm (LLaVA) ---
    n_img_tokens: int = 0
    # --- quantized flow / LOP ---
    quant: str = "ternary"      # ternary | bf16
    lop_block: int = 128        # KV candidate-block granularity (tokens)
    lop_keep: float = 0.125     # K/M — fraction of blocks kept by the screen
    use_lop: bool = True
    # --- decode variants; None is pinned by resolve_decode_flags ---
    gqa_shared_select: bool | None = None
    int8_logits: bool | None = None
    # --- misc ---
    norm: str = "rmsnorm"
    gated_ffn: bool = True
    dtype: str = "float32"
    act_dtype: str = "bfloat16"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.hd

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.hd

    @property
    def vocab_padded(self) -> int:
        return -(-self.vocab // 256) * 256

    @property
    def d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    def is_attn_layer(self, i: int) -> bool:
        if self.family == "ssm":
            return False
        if self.family == "hybrid":
            return i % self.attn_every == self.attn_every // 2
        return True

    def is_moe_layer(self, i: int) -> bool:
        if self.n_experts == 0:
            return False
        if self.moe_every:
            return i % self.moe_every == 1
        return True

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def resolve_decode_flags(cfg: ModelConfig) -> ModelConfig:
    """Pin ``gqa_shared_select`` and ``int8_logits`` to booleans.

    A field left ``None`` becomes ``False``: the port reads no environment
    flags, so a served config always says what its kernels run.
    """
    if cfg.gqa_shared_select is not None and cfg.int8_logits is not None:
        return cfg
    return cfg.replace(gqa_shared_select=bool(cfg.gqa_shared_select),
                       int8_logits=bool(cfg.int8_logits))


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _load_all()
    return _REGISTRY[name]


def _load_all() -> None:
    from repro_torch.configs import bitnet_3b  # noqa: F401  (registers)


def resolve_config(arch: str, reduced: bool = False) -> ModelConfig:
    """``--arch`` id (and ``--reduced``) → config."""
    return get_config(f"{arch}-reduced" if reduced else arch)
