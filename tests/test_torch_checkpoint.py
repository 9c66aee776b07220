"""The port's checkpoint store and training loop on the CPU:

  * the reference's ``tests/test_checkpoint.py`` cases against the port's
    store: round trip (an AdamW state's NamedTuple too), ``keep`` garbage
    collection, an incomplete step ignored, a structure and a shape
    mismatch raising;
  * a params checkpoint the reference wrote loads into the port bitwise,
    and one the port wrote loads into the reference bitwise (the same
    npz keys and ``keystr`` manifest);
  * train → preempt at step 10 (checkpointed) → restart: the resumed
    losses and final masters bitwise the uninterrupted run's;
  * the reduced lifecycle (the reference's
    ``test_train_quantize_serve_lifecycle``): 40 QAT steps, the loss
    falls, ``quantize_params`` on the trained masters, then a lockstep
    and a Scheduler serve on the CPU: logits finite, every request its
    full length, the Scheduler's tokens equal to lockstep's;
  * the CLI: ``--device cpu`` trains and prints the reference's lines;
    without ``--device`` it asks for the card and raises where there is
    none.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.store import load_checkpoint as jload
from repro.checkpoint.store import save_checkpoint as jsave
from repro.models.transformer import init_params as jinit
from repro_torch.checkpoint.store import (latest_step, load_checkpoint,
                                          save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.convert import from_numpy_tree
from repro_torch.launch.train import main, train_loop
from repro_torch.models.transformer import init_params
from repro_torch.serving.api import GenerateRequest, PooledEngine
from repro_torch.serving.quantize import quantize_params
from repro_torch.serving.scheduler import Scheduler, lockstep_generate
from repro_torch.training.optimizer import adamw_init
from repro_torch.tree_util import flatten_with_path, leaves

from tests.test_models_smoke import _reduced

torch.set_num_threads(1)


def _tree(rng):
    return {"a": torch.from_numpy(rng.standard_normal((4, 8)).astype(
                np.float32)),
            "nested": {"b": torch.arange(10, dtype=torch.int32)}}


def test_roundtrip(tmp_path, rng):
    tree = (_tree(rng), adamw_init(_tree(rng)))
    save_checkpoint(str(tmp_path), 7, tree, extra={"note": "x"})
    out, step, extra = load_checkpoint(str(tmp_path), tree)
    assert step == 7 and extra == {"note": "x"}
    assert type(out[1]) is type(tree[1])
    for a, b in zip(leaves(tree), leaves(out)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with open(tmp_path / "step_00000007" / "manifest.json") as f:
        keys = json.load(f)["keys"]
    assert keys[:2] == ["[0]['a']", "[0]['nested']['b']"]
    assert "[1].step" in keys and "[1].m['a']" in keys


def test_latest_and_gc(tmp_path, rng):
    tree = _tree(rng)
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(str(tmp_path), s, tree, keep=3)
    assert latest_step(str(tmp_path)) == 5
    assert sorted(os.listdir(tmp_path)) == [
        "step_00000003", "step_00000004", "step_00000005"]


def test_incomplete_checkpoint_ignored(tmp_path, rng):
    """A .tmp directory (a crash mid-save) and a step directory without a
    manifest are invisible to restore."""
    tree = _tree(rng)
    save_checkpoint(str(tmp_path), 1, tree)
    os.makedirs(tmp_path / "step_00000002.tmp")
    os.makedirs(tmp_path / "step_00000003")
    assert latest_step(str(tmp_path)) == 1
    _, step, _ = load_checkpoint(str(tmp_path), tree)
    assert step == 1


def test_structure_mismatch_raises(tmp_path, rng):
    save_checkpoint(str(tmp_path), 1, _tree(rng))
    with pytest.raises(ValueError):
        load_checkpoint(str(tmp_path), {"different": torch.zeros(3)})


def test_shape_mismatch_raises(tmp_path, rng):
    tree = _tree(rng)
    save_checkpoint(str(tmp_path), 1, tree)
    bad = dict(tree, a=torch.zeros((2, 2)))
    with pytest.raises(ValueError):
        load_checkpoint(str(tmp_path), bad)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_params_checkpoint_crosses_bitwise(tmp_path, writer):
    """bitnet-3b-reduced's master tree written by one side, read by the
    other into its own tree of the same structure: every leaf bitwise."""
    jparams, _ = jinit(_reduced("bitnet-3b"), jax.random.PRNGKey(0))
    want = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(jparams)[0]}
    tlike = init_params(get_config("bitnet-3b-reduced"), 1)
    if writer == "reference":
        jsave(str(tmp_path), 3, jparams)
        got, step, _ = load_checkpoint(str(tmp_path), tlike)
        got = {k: v.numpy() for k, v in flatten_with_path(got)}
    else:
        save_checkpoint(str(tmp_path), 3,
                        from_numpy_tree(jax.tree.map(np.asarray, jparams),
                                        "cpu"))
        got, step, _ = jload(str(tmp_path), jparams)
        got = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
               jax.tree_util.tree_flatten_with_path(got)[0]}
    assert step == 3 and got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


class _PreemptAt:
    """A preemption flag firing after ``at`` polls (one a step)."""

    def __init__(self, at):
        self.at, self.n = at, 0

    @property
    def preempted(self):
        self.n += 1
        return self.n > self.at


def test_train_restart_resumes_identically(tmp_path):
    """20 straight steps == preempted after 11 (checkpointed) + a restart
    for the rest, on the same 20-step schedule: losses and masters
    bitwise."""
    cfg = get_config("stablelm-1.6b-reduced").replace(n_layers=2)
    kw = dict(steps=20, global_batch=4, seq_len=16, peak_lr=1e-3,
              log_every=1000, device="cpu")
    straight = train_loop(cfg, **kw)
    part1 = train_loop(cfg, ckpt_dir=str(tmp_path), ckpt_every=100,
                       preemption=_PreemptAt(10), **kw)
    assert part1["last_step"] == 11
    part2 = train_loop(cfg, ckpt_dir=str(tmp_path), ckpt_every=100, **kw)
    assert part2["last_step"] == 20
    assert part1["losses"] + part2["losses"] == straight["losses"]
    for a, b in zip(leaves(straight["params"]), leaves(part2["params"])):
        assert torch.equal(a, b)


def test_train_quantize_serve_lifecycle():
    cfg = get_config("bitnet-3b-reduced").replace(n_layers=2, vocab=256)
    out = train_loop(cfg, steps=40, global_batch=8, seq_len=32,
                     peak_lr=3e-3, log_every=1000, device="cpu")
    assert np.mean(out["losses"][-5:]) < np.mean(out["losses"][:5])

    qp = quantize_params(cfg, out["params"])
    engine = PooledEngine(cfg, qp, max_len=24, device="cpu")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    logits, _ = engine.prefill(prompts)
    assert torch.isfinite(logits).all()
    want = [lockstep_generate(engine, p, 4) for p in prompts]
    sched = Scheduler(engine, n_slots=2)
    for rid, p in enumerate(prompts):
        sched.submit(GenerateRequest(rid=rid, prompt=p, max_new_tokens=4))
    got = {r.rid: r.tokens for r in sched.run_to_completion()}
    assert [got[0], got[1]] == want
    assert all(len(t) == 4 and all(0 <= x < cfg.vocab_padded for x in t)
               for t in want)


def test_train_cli_prints_the_reference_lines(capsys):
    assert main(["--reduced", "--device", "cpu", "--steps", "3",
                 "--seq", "16", "--global-batch", "2"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("training bitnet-3b-reduced (dense) for 3 "
                             "steps, batch 2 × seq 16")
    assert out[1].startswith("step     0 loss ")
    assert out[-1].startswith("loss ") and out[-1].endswith(
        " over 3 steps")


def test_train_cli_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the CLI would train on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--reduced", "--steps", "1"])
