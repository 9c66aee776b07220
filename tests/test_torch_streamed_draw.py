"""The streamed draw on the CPU: ``init_serving_params`` — each stack
entry drawn, quantized and written into a serving tree allocated once —
is bitwise ``quantize_params(init_params(...))`` for the reduced config
of every family, with LayerNorm (stablelm) and the QKV bias (qwen) among
the dense ones; and ``draw_params`` yields the entries in the order, and
with the values, that ``init_params`` stacks."""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models.transformer import draw_params, init_params
from repro_torch.serving.quantize import init_serving_params, quantize_params

torch.set_num_threads(1)

ARCHS = ("bitnet-3b-reduced", "granite-moe-1b-a400m-reduced",
         "stablelm-1.6b-reduced", "qwen1.5-32b-reduced",
         "whisper-small-reduced", "rwkv6-1.6b-reduced",
         "jamba-1.5-large-398b-reduced", "llava-next-34b-reduced",
         "mistral-nemo-12b-reduced")


def _flat(tree, path=()):
    for name, val in tree.items():
        if isinstance(val, dict):
            yield from _flat(val, path + (name,))
        else:
            yield path + (name,), val


@pytest.mark.parametrize("arch", ARCHS)
def test_streamed_draw_bitwise_whole_tree(arch):
    cfg = get_config(arch)
    want = dict(_flat(quantize_params(cfg, init_params(cfg, 5, "cpu"))))
    got = dict(_flat(init_serving_params(cfg, 5, "cpu")))
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        assert got[path].dtype == leaf.dtype, path
        assert torch.equal(got[path], leaf), path
    paths = {"/".join(p) for p in want}
    if cfg.norm != "rmsnorm":
        assert "ln_f/b" in paths
    if cfg.qkv_bias:
        assert "layers/attn/wqkv/b" in paths
    if cfg.family == "vlm":
        assert "projector/w" in paths


def test_draw_order_is_the_stacked_tree():
    """embed, ln_f, head, the encoder layers in order, ln_enc, then the
    decoder layers in order; each entry is its slice of ``init_params``'
    stack, bitwise."""
    cfg = get_config("whisper-small-reduced")
    whole = init_params(cfg, 2, "cpu")
    order = []
    for name, i, n, tree in draw_params(cfg, 2, "cpu"):
        order.append(name if i is None else (name, i, n))
        want = dict(_flat(whole[name]))
        for path, leaf in _flat(tree):
            ref = want[path] if i is None else want[path][i]
            assert torch.equal(leaf, ref), (name, i, path)
    e, d = cfg.n_encoder_layers, cfg.n_layers
    assert order == (["embed", "ln_f", "head"]
                     + [("enc_layers", i, e) for i in range(e)] + ["ln_enc"]
                     + [("layers", i, d) for i in range(d)])
    assert list(whole) == ["embed", "ln_f", "head", "enc_layers", "ln_enc",
                           "layers"]


def test_hybrid_draw_yields_one_sublayer_at_a_time():
    """A superblock comes as its ``attn_every`` sublayers in order, each
    entry ``{"sub{j}": sublayer}`` bitwise its slice of ``init_params``'
    stack."""
    cfg = get_config("jamba-1.5-large-398b-reduced")
    whole = init_params(cfg, 2, "cpu")
    order = []
    for name, i, n, tree in draw_params(cfg, 2, "cpu"):
        if i is None:
            continue
        (sub,) = tree
        order.append((name, i, n, sub))
        want = dict(_flat(whole[name][sub]))
        for path, leaf in _flat(tree[sub]):
            assert torch.equal(leaf, want[path][i]), (i, sub, path)
    n = cfg.n_layers // cfg.attn_every
    assert order == [("blocks", i, n, f"sub{j}") for i in range(n)
                     for j in range(cfg.attn_every)]


def test_full_width_jamba_draw_holds_one_sublayer():
    """Full-width jamba-1.5-large-398b walked on ``meta`` (nothing drawn):
    no entry exceeds one sublayer's masters (a Mamba or attention mixer
    and an MoE of 16 experts of f 24,576: ~40 GB), where a whole
    superblock is ~176 GB, so the streamed draw of one superblock fits a
    card of 80 GB beside its ~15 GB served tree."""
    cfg = get_config("jamba-1.5-large-398b")
    sizes, per_block = [], {}
    for name, i, _, tree in draw_params(cfg, 0, "meta"):
        b = sum(leaf.numel() * leaf.element_size() for _, leaf in _flat(tree))
        if i is not None:
            sizes.append(b)
            per_block[i] = per_block.get(i, 0) + b
    assert len(sizes) == cfg.n_layers
    assert max(sizes) <= 41e9
    assert min(per_block.values()) >= 170e9
