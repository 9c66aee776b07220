"""The port's architecture configs against the reference's: every
assigned architecture and bitnet-3b, full and ``-reduced``, field for
field and in every derived width; and which families the port serves.
"""
import dataclasses
import importlib

import pytest
import torch

from repro_torch.configs import all_configs, get_config, resolve_config
from repro_torch.models.transformer import init_params
from repro_torch.serving.api import PooledEngine
from repro_torch.serving.cache import init_cache
from repro_torch.serving.quantize import init_serving_params

torch.set_num_threads(1)

MODULES = ("bitnet_3b", "granite_moe_1b_a400m", "jamba_1_5_large_398b",
           "llava_next_34b", "mistral_nemo_12b", "mixtral_8x22b",
           "qwen1_5_110b", "qwen1_5_32b", "rwkv6_1_6b", "stablelm_1_6b",
           "whisper_small")
SERVED = ("dense", "moe", "encdec", "ssm", "hybrid", "vlm")


def _pair(module: str, which: str):
    ref = getattr(importlib.import_module(f"repro.configs.{module}"), which)
    port = getattr(importlib.import_module(f"repro_torch.configs.{module}"),
                   which)
    return ref, port


@pytest.mark.parametrize("which", ["CONFIG", "REDUCED"])
@pytest.mark.parametrize("module", MODULES)
def test_config_field_equal_reference(module, which):
    ref, port = _pair(module, which)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    for prop in ("hd", "q_dim", "kv_dim", "vocab_padded", "d_inner"):
        assert getattr(port, prop) == getattr(ref, prop), prop
    for i in range(port.n_layers):
        assert port.is_attn_layer(i) == ref.is_attn_layer(i)
        assert port.is_moe_layer(i) == ref.is_moe_layer(i)
    # registered under its own name, and reachable through --reduced
    assert get_config(port.name) is port
    base = port.name.removesuffix("-reduced")
    assert resolve_config(base, which == "REDUCED") is port


def test_registry_holds_every_config():
    from repro.configs import all_configs as ref_all
    names = {c.name for c in ref_all().values()}
    assert names <= set(all_configs())
    assert len(all_configs()) == 2 * len(MODULES)


@pytest.mark.parametrize("module", MODULES)
def test_unserved_families_raise(module):
    """Every family is served now (the vlm family since the image prefix
    was ported): each config's family builds its weights' tree, its cache
    and its engine, and no family is left to raise."""
    _, cfg = _pair(module, "REDUCED")
    assert cfg.family in SERVED
    assert init_cache(cfg, 1, 8, "cpu")["lengths"].shape == (1,)
    qp = init_serving_params(cfg, 0, "cpu")
    assert PooledEngine(cfg, qp, max_len=8, device="cpu").state_kind


def test_moe_master_tree():
    """The moe layer tree of the reference's ``moe_init``: router [d, E]
    and the expert stacks, from one generator (the same seed, the same
    weights)."""
    cfg = get_config("granite-moe-1b-a400m-reduced")
    a = init_params(cfg, 3, "cpu")
    b = init_params(cfg, 3, "cpu")
    moe = a["layers"]["moe"]
    n, d, f, e = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.n_experts
    assert {k: tuple(v.shape) for k, v in moe.items()} == {
        "router": (n, d, e), "w_gate": (n, e, d, f), "w_up": (n, e, d, f),
        "w_down": (n, e, f, d)}
    assert "ffn" not in a["layers"]
    for k, v in moe.items():
        assert torch.equal(v, b["layers"]["moe"][k])
    # fan-in scaling: d^-0.5 for router, gate and up; f^-0.5 for down
    assert abs(float(moe["w_down"].std()) * f ** 0.5 - 1) < 0.05
    assert abs(float(moe["w_up"].std()) * d ** 0.5 - 1) < 0.05
