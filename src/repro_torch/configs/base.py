"""Model configuration: every architecture is a ``ModelConfig``.

A jax-free copy of the reference's config record (same fields, same
derived properties). Every family — dense, moe, encdec, ssm, hybrid and
vlm — is served by this package.
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


# ---------------------------------------------------------------------------
# Input shapes (the reference's assigned set — seq_len × global_batch)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# smoke-scale variants of the same shapes (CPU tests)
SMOKE_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 64, 2, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 128, 2, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 128, 2, "decode"),
    "long_500k": ShapeConfig("long_500k", 256, 1, "decode"),
}


def text_len(cfg: ModelConfig, seq_len: int, kind: str) -> int:
    """Token length of the decoder's text stream for a cell's ``seq_len``
    (the reference's): encdec counts audio frames, its text is a quarter;
    vlm's image tokens come out of it at training and prefill."""
    if cfg.family == "encdec":
        return max(seq_len // 4, 8)
    if cfg.family == "vlm" and kind in ("train", "prefill"):
        return max(seq_len - cfg.n_img_tokens, 8)
    return seq_len


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runs?, reason-if-skipped), the reference's rule: ``long_500k``
    runs only for the sub-quadratic families (ssm, hybrid); the reason is
    the reference's, word for word."""
    if shape.name == "long_500k":
        if cfg.family in ("ssm", "hybrid"):
            return True, ""
        return False, ("long_500k needs sub-quadratic attention; "
                       f"{cfg.name} is full-attention — skipped per brief "
                       "(noted in DESIGN.md §Arch-applicability)")
    return True, ""


def input_specs(cfg: ModelConfig, shape: ShapeConfig, device="meta") -> dict:
    """Stand-ins for every model input of a cell: the reference's
    ``input_specs`` with tensors on ``device`` (``meta``: shapes and
    dtypes, no storage) in place of its ``ShapeDtypeStruct``s. The dtypes
    are the ones the port's entry points take: tokens and labels int32;
    ``frames`` (encdec) and ``patches`` (vlm) f32, where the reference
    gives bf16 (the port's trainer and engine take them as f32, as its
    data pipeline makes them, and cast at use). Train: tokens, labels
    (and frames or patches); prefill: tokens (and frames or patches);
    decode: one new token a sequence (the cache is passed apart)."""
    import torch
    b, s = shape.global_batch, shape.seq_len

    def make(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device=device)
    if shape.kind == "decode":
        return {"tokens": make((b, 1), torch.int32)}
    t = text_len(cfg, s, shape.kind)
    specs = {"tokens": make((b, t), torch.int32)}
    if shape.kind == "train":
        specs["labels"] = make((b, t), torch.int32)
    if cfg.family == "encdec":
        specs["frames"] = make((b, s, cfg.d_model), torch.float32)
    if cfg.family == "vlm":
        specs["patches"] = make((b, cfg.n_img_tokens, cfg.d_model),
                                torch.float32)
    return specs


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _load_all()
    return _REGISTRY[name]


def all_configs() -> dict[str, ModelConfig]:
    """Every registered config, full and ``-reduced``."""
    _load_all()
    return dict(_REGISTRY)


def _load_all() -> None:
    # importing a config module registers its CONFIG and REDUCED
    from repro_torch.configs import (bitnet_3b,  # noqa: F401
                                     granite_moe_1b_a400m,
                                     jamba_1_5_large_398b, llava_next_34b,
                                     mistral_nemo_12b, mixtral_8x22b,
                                     qwen1_5_110b, qwen1_5_32b, rwkv6_1_6b,
                                     stablelm_1_6b, whisper_small)


def resolve_config(arch: str, reduced: bool = False) -> ModelConfig:
    """``--arch`` id (and ``--reduced``) → config."""
    return get_config(f"{arch}-reduced" if reduced else arch)
