"""The port's three examples (``examples/torch_{quickstart,serve_lop,
train_bitnet}.py``) on the CPU, held against the reference's examples:

  * quickstart: on the reference's weights (converted), the port's
    pipeline prints the reference example's lines — the fused QKV's
    shape, the prefill, the 16-token greedy continuation of 4 prompts and
    the K/V bytes line — character for character, but for one token of
    the 64 where the streams part at a rounding tie of the prefill (shown
    to be one); the port's own entry point prints the reference's model
    and K/V bytes lines;
  * serve_lop at ``--batch 2 --prompt-len 24 --gen 6``: the continuous
    batching and sampled demos report full lockstep agreement;
  * train_bitnet with its config replaced by a tiny one: the loss falls
    (the example's own gate), and a run preempted at step 6 and resumed
    from its checkpoint ends with the uninterrupted run's losses and
    masters, bitwise.

The reference example's decode step is jitted here (as its serve_lop
example jits its own), so the whole reference run takes seconds."""
import contextlib
import importlib.util
import io
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.serving.engine import serve_step as jserve_step
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import from_numpy_tree
from repro_torch.serving import engine as teng

torch.set_num_threads(1)

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"examples_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue().splitlines()


@pytest.fixture(scope="module")
def reference_quickstart():
    """The reference example's printed lines (its step jitted), the
    deployed tree it built and its prefill's cache."""
    mod = _load("quickstart")
    mod.serve_step = jax.jit(jserve_step, static_argnums=(0,))
    built, prefilled = [], []
    quantize, prefill = mod.quantize_params, mod.prefill

    def keep(cfg, params):
        built.append(quantize(cfg, params))
        return built[-1]

    def keep_cache(*args, **kw):
        prefilled.append(prefill(*args, **kw))
        return prefilled[-1]
    mod.quantize_params, mod.prefill = keep, keep_cache
    _, lines = _printed(mod.main)
    return lines, built[0], prefilled[0][1]


def _row(line: str) -> list:
    return [int(t) for t in line.strip(" []").split()]


def test_quickstart_on_reference_weights_prints_reference_lines(
        reference_quickstart, monkeypatch):
    """Every line the reference example prints after its model line, on
    its own weights, but one token: prompt 3's 12th token, where the
    streams part at a rounding tie of layer 0's prefill V (the 1-ulp
    requantization knife-edge, ROADMAP queue 3), then join again."""
    lines, jqp, jcache = reference_quickstart
    quick = _load("torch_quickstart")
    cfg = quick.CFG.replace(lop_keep=0.25)
    qp = from_numpy_tree(jax.tree.map(np.asarray, jqp), "cpu")
    seen, real_q = [], teng._q
    monkeypatch.setattr(teng, "_q", lambda x: seen.append(x) or real_q(x))
    out, got = _printed(quick.run, cfg, qp, torch.device("cpu"))
    want = lines[1:]
    last = want.index("greedy continuation:") + 4     # prompt 3's row
    assert got[:last] == want[:last] and got[last + 1:] == want[last + 1:]
    a, b = _row(got[last]), _row(want[last])
    assert [i for i in range(len(a)) if a[i] != b[i]] == [11]
    assert out["continuation"].shape == (4, 16)
    assert out["kv_bytes"] == (2560, 1280)

    # the cause: layer 0's prefill pages part from the reference's at two
    # int8 V values of prompt 3, each f32 value within 1e-5 of a
    # half-integer of its scale (the reference's pages are its own
    # example's prefill)
    for name, x in (("k", seen[1]), ("v", seen[2])):      # layer 0's
        q = real_q(x)
        mine = q[0].transpose(1, 2)
        theirs = torch.from_numpy(np.array(jcache["layers"][name][0, :, :,
                                                                  :24]))
        apart = (mine != theirs).nonzero().tolist()
        assert len(apart) == 2 * (name == "v"), (name, apart)
        for lane, head, pos, col in apart:
            ratio = float(x[lane, pos, head, col] / q[1][lane, pos, head, 0])
            assert abs(abs(ratio) % 1 - 0.5) < 1e-5, ratio


def test_quickstart_entry_point_on_cpu(reference_quickstart):
    quick = _load("torch_quickstart")
    rc, lines = _printed(quick.main, ["--device", "cpu"])
    want, _, _ = reference_quickstart
    assert rc == 0
    assert lines[0] == want[0]                         # the model line
    assert lines[-1] == want[-1]                       # the K/V bytes line


def test_serve_lop_reports_full_lockstep_agreement():
    serve = _load("torch_serve_lop")
    args = serve.parse_args(["--device", "cpu", "--batch", "2",
                             "--prompt-len", "24", "--gen", "6"])
    out, lines = _printed(serve.demo, args)
    assert set(out["agreement"]) == {1.0, 0.5, 0.25}
    for part, n in (("batching", 4), ("sampled", 2)):
        assert len(out[part]["results"]) == n
        assert out[part]["agree"] == n and out[part]["verified"], part
    assert "  lockstep agreement 4/4" in " ".join(lines)
    assert any(line.startswith("sampled serving") and " 2/2 pool" in line
               for line in lines)
    assert any("no CUDA graphs" in line for line in lines)


TINY = ModelConfig(name="bitnet-tiny", family="dense", n_layers=2,
                   d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                   vocab=256, head_dim=16)
SHAPE = dict(global_batch=4, seq=32)


class _StopAt:
    """Preempted once the loop polls it after step ``n``."""

    def __init__(self, n: int):
        self.n, self.polls = n, 0

    @property
    def preempted(self) -> bool:
        self.polls += 1
        return self.polls >= self.n


def test_train_bitnet_loss_falls(tmp_path, monkeypatch):
    train = _load("torch_train_bitnet")
    monkeypatch.setattr(train, "CFG_100M", TINY)
    rc, lines = _printed(train.main, [
        "--device", "cpu", "--steps", "12", "--seq", str(SHAPE["seq"]),
        "--global-batch", str(SHAPE["global_batch"]),
        "--ckpt-dir", str(tmp_path)])
    assert rc == 0 and lines[-1].startswith("OK — checkpoints in")
    assert lines[0].startswith("training bitnet-tiny")


def test_train_bitnet_resume_is_the_uninterrupted_run(tmp_path,
                                                     monkeypatch):
    """Preempted at step 6 and resumed: the uninterrupted run's losses
    and masters, bitwise; each checkpointed step written once."""
    from repro_torch.launch import train as loop
    train = _load("torch_train_bitnet")
    saved, real_save = [], loop.save_checkpoint
    monkeypatch.setattr(loop, "save_checkpoint", lambda d, step, *a, **k: (
        saved.append((Path(d).name, step)), real_save(d, step, *a, **k)))
    kw = dict(steps=12, device="cpu", ckpt_every=3, **SHAPE)
    whole, _ = _printed(train.train, TINY, ckpt_dir=str(tmp_path / "a"),
                        **kw)
    first, _ = _printed(train.train, TINY, ckpt_dir=str(tmp_path / "b"),
                        preemption=_StopAt(6), **kw)
    assert first["last_step"] == 6
    rest, lines = _printed(train.train, TINY, ckpt_dir=str(tmp_path / "b"),
                           **kw)
    assert "resumed from step 6" in lines
    assert saved == [("a", 3), ("a", 6), ("a", 9), ("a", 12),
                     ("b", 3), ("b", 6), ("b", 9), ("b", 12)]
    assert first["losses"] + rest["losses"] == whole["losses"]
    assert whole["losses"][-1] < whole["losses"][0]
    for a, b in zip(jax.tree.leaves(rest["params"]),
                    jax.tree.leaves(whole["params"])):
        assert torch.equal(a, b)
