"""The port's vlm family on ``llava-next-34b-reduced`` (3 layers, d 128, 4
heads of 32 over 2, 16 image tokens, ``lop_block`` 32), held against the
JAX reference on the CPU with the reference's weights:

  * the master tree has the reference's paths and shapes (the f32
    ``projector`` [d, d] after the layers) and the serving tree keeps the
    projector f32, as the reference's ``_KEEP_FP`` does;
  * ``_embed`` with patches (the f32 projector product before the text
    embeddings) within 1e-6 of the reference's;
  * whole prefill with patches: logits within rtol = atol = 2e-5, the
    int8 pages and LOP features of layer 0 bitwise the reference's, later
    layers' apart only at 1-ulp knife-edges (as a text-only prompt's);
  * the counterpart of the reference's
    ``test_vlm_image_prefix_rides_first_chunk``: the image rides the first
    chunk (embedded width n_img + C at start 0, a later chunk past the
    prefix, an exact tail at the capacity edge), and the Scheduler's
    greedy tokens equal the reference's ``lockstep_generate(...,
    patches=)``, LOP and no-LOP, and the port's own run-to-completion;
  * the counterpart of the reference's
    ``test_greedy_spec_matches_lockstep_vlm``: greedy speculation (no-LOP)
    on vlm equals the reference's lockstep;
  * image requests never match or intern prefix pages, while text-only
    requests on the same engine do;
  * ``prefix_len + prompt + max_new > capacity`` is refused at submit,
    and patches on an engine of another family are refused too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.llava_next_34b import REDUCED as JCFG
from repro.models.transformer import init_params as jinit
from repro.serving import engine as jeng
from repro.serving.quantize import quantize_params as jquantize
from repro.serving.scheduler import _ref_engine
from repro.serving.scheduler import lockstep_generate as jlockstep
from repro_torch.configs import get_config
from repro_torch.convert import from_numpy_tree
from repro_torch.models.transformer import init_params
from repro_torch.serving import engine as teng
from repro_torch.serving.api import GenerateRequest, PooledEngine
from repro_torch.serving.quantize import quantize_params
from repro_torch.serving.scheduler import Scheduler, lockstep_generate

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)
MAX_LEN = 60          # the reference's scenario: capacity 64
CFG = get_config("llava-next-34b-reduced")


def _flat(tree) -> dict:
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


@pytest.fixture(scope="module")
def weights():
    params, _ = jinit(JCFG, jax.random.PRNGKey(0))
    jqp = jquantize(JCFG, params)
    return jqp, from_numpy_tree(jax.tree.map(np.asarray, jqp), "cpu")


@pytest.fixture(scope="module")
def engines(weights):
    """The port's LOP and no-LOP engines on the reference's weights,
    shared by every case."""
    _, tqp = weights
    return {lop: PooledEngine(CFG, tqp, max_len=MAX_LEN, use_lop=lop,
                              device="cpu") for lop in (True, False)}


def _patches(rng):
    return (rng.standard_normal((CFG.n_img_tokens, CFG.d_model))
            .astype(np.float32) * 0.02)


def _requests(lens=(7, 40), seed=6, gen=4):
    """Image requests: a prompt of each length and its patches; 40 text
    tokens make a first chunk of 16 + 32 rows, then an 8-token exact tail
    at the capacity edge (16 + 32 + 32 > 64)."""
    rng = np.random.default_rng(seed)
    reqs = []
    for rid, plen in enumerate(lens):
        prompt = rng.integers(0, CFG.vocab, (plen,)).astype(np.int32)
        reqs.append(GenerateRequest(rid=rid, prompt=prompt,
                                    max_new_tokens=gen,
                                    patches=_patches(rng)))
    return reqs


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def test_master_and_serving_trees_match_reference(weights):
    jqp, tqp = weights
    params, _ = jinit(JCFG, jax.random.PRNGKey(0))
    ours = _flat(init_params(CFG, 7, "cpu"))
    ref = _flat(params)
    assert set(ours) == set(ref)
    for path, leaf in ref.items():
        assert ours[path].shape == leaf.shape, path
    assert list(init_params(CFG, 7, "cpu"))[-1] == "projector"
    got = _flat(quantize_params(CFG, from_numpy_tree(
        jax.tree.map(np.asarray, params), "cpu")))
    want = _flat(jax.tree.map(np.asarray, jqp))
    assert set(got) == set(want)
    assert np.array_equal(got[next(p for p in got if "projector" in
                                   jax.tree_util.keystr(p))].numpy(),
                          np.asarray(params["projector"]["w"]))
    for path, leaf in want.items():
        if "scale" in jax.tree_util.keystr(path):
            np.testing.assert_allclose(got[path].numpy(), leaf, rtol=1e-6,
                                       atol=0, err_msg=str(path))
        else:
            assert np.array_equal(got[path].numpy(), leaf), path


# ---------------------------------------------------------------------------
# embedding and prefill
# ---------------------------------------------------------------------------

def test_embed_with_patches_matches_reference(weights):
    jqp, tqp = weights
    req = _requests()[1]
    want = jeng._embed(JCFG, jqp, jnp.asarray(req.prompt)[None],
                       jnp.asarray(req.patches)[None])
    got = teng._embed(CFG, tqp, _t(req.prompt).long()[None],
                      _t(req.patches)[None])
    assert got.shape == (1, CFG.n_img_tokens + len(req.prompt), CFG.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # the text rows are the embedding rows, bitwise
    assert torch.equal(got[0, CFG.n_img_tokens:],
                       tqp["embed"]["table"][_t(req.prompt).long()])
    with pytest.raises(ValueError, match="patches"):
        teng._embed(get_config("bitnet-3b-reduced"), tqp,
                    _t(req.prompt).long()[None], _t(req.patches)[None])


def _pages_match(cache, jc) -> None:
    """A prefill's pages against the reference's: layer 0's int8 K/V and
    packed LOP features bitwise (its input, the embedded rows, is bitwise),
    scales within 1e-6 everywhere (RMSNorm and RoPE round apart by ulps);
    past layer 0 the int8 K/V part only by ±1 at 1-ulp knife-edges, in at
    most one position a layer, and the features only where K parts. (A
    text-only prompt of the dense stack parts the same way: ROADMAP queue
    3, "Rounding partings".)"""
    layers = {key: (cache["layers"][key].numpy(), np.asarray(leaf))
              for key, leaf in jc["layers"].items()}
    for key, (ours, want) in layers.items():
        assert ours.shape == want.shape, key
        if key.endswith("scale"):
            np.testing.assert_allclose(ours, want, rtol=1e-6, atol=0,
                                       err_msg=key)
            continue
        assert np.array_equal(ours[0], want[0]), key
    apart = {}
    for key in ("k", "v"):
        ours, want = layers[key]
        diff = ours.astype(np.int32) - want
        assert np.abs(diff).max() <= 1, key
        for lyr, _, _, pos, _ in np.argwhere(diff):
            apart.setdefault(key, set()).add((int(lyr), int(pos)))
    for lyr in range(1, CFG.n_layers):
        assert len({p for pk in apart.values() for (l, p) in pk
                    if l == lyr}) <= 1, apart
    ours, want = layers["feat"]
    for lyr, _, _, pos, _ in np.argwhere(ours != want):
        assert (int(lyr), int(pos)) in apart.get("k", ()), (lyr, pos)


def test_prefill_with_patches_matches_reference(weights):
    """Logits within 2e-5; the pages as :func:`_pages_match` holds them;
    the lane's length counts the image rows."""
    jqp, tqp = weights
    for req in _requests():
        want, jc = _ref_engine(JCFG, jqp, True, MAX_LEN).prefill(
            req.prompt[None], CFG.n_img_tokens + len(req.prompt),
            {"patches": jnp.asarray(req.patches)[None]})
        got, cache = teng.prefill(CFG, tqp, _t(req.prompt).long()[None],
                                  max_len=MAX_LEN,
                                  patches=_t(req.patches)[None])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert int(cache["lengths"][0]) == int(jc["lengths"][0]) == \
            CFG.n_img_tokens + len(req.prompt)
        _pages_match(cache, jc)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_lop", [True, False], ids=["lop", "no-lop"])
def test_image_prefix_rides_first_chunk(weights, engines, use_lop):
    jqp, _ = weights
    eng = engines[use_lop]
    assert eng.supports_chunked and eng.has_image_prefix
    assert eng.supports_speculative and eng.prefix_block == CFG.lop_block
    reqs = _requests()
    sched = Scheduler(eng, n_slots=2, check_invariants=True)
    assert sched.chunked and sched.capacity == 64
    for r in reqs:
        sched.submit(r)
    # the image rides the first chunk: 16 + 32 rows at start 0, then the
    # 8-token exact tail at 16 + 32
    pf = sched._prefilling
    sched.admit()
    assert [p.starts for p in pf] == [[0], [0, 48]]
    assert [p.seq_ends for p in pf] == [[23], [48, 56]]
    assert [c.shape[1] for c in pf[1].chunks] == [32, 8]
    got = {r.rid: r.tokens for r in sched.run_to_completion()}
    whole = Scheduler(eng, n_slots=2, chunked=False)
    for r in reqs:
        whole.submit(r)
    assert {r.rid: r.tokens for r in whole.run_to_completion()} == got
    for r in reqs:
        want = jlockstep(JCFG, jqp, r.prompt, 4, max_len=MAX_LEN,
                         use_lop=use_lop, patches=r.patches)
        assert got[r.rid] == want, r.rid
        assert lockstep_generate(eng, r.prompt, 4,
                                 patches=r.patches) == want, r.rid


def test_greedy_spec_matches_lockstep_vlm(weights, engines):
    jqp, _ = weights
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, CFG.vocab, (8,)).astype(np.int32)
    patches = _patches(rng)
    sched = Scheduler(engines[False], n_slots=1, spec_decode=True, gamma=3,
                      check_invariants=True)
    sched.submit(GenerateRequest(rid=0, prompt=prompt, max_new_tokens=10,
                                 patches=patches))
    res = sched.run_to_completion()
    assert sched.spec and sched.spec_rounds > 0
    want = jlockstep(JCFG, jqp, prompt, 10, max_len=MAX_LEN, use_lop=False,
                     patches=patches)
    assert res[0].tokens == want


def test_image_requests_bypass_the_prefix_store(engines):
    """Two image requests with the same 40-token text: no hit, nothing
    interned. Then two text-only requests sharing 40 tokens on the same
    engine: the first interns one 32-token block and the second hits it,
    with the lockstep's tokens."""
    eng = engines[True]
    rng = np.random.default_rng(12)
    text = rng.integers(0, CFG.vocab, (40,)).astype(np.int32)
    sched = Scheduler(eng, n_slots=2, check_invariants=True)
    store = sched.prefix_store
    for rid in range(2):
        sched.submit(GenerateRequest(rid=rid, prompt=text, max_new_tokens=3,
                                     patches=_patches(rng)))
        sched.run_to_completion()
    assert sched.prefix_hits == 0 and store.missing(text[:32])
    assert store.cached_tokens == 0
    tails = [rng.integers(0, CFG.vocab, (n,)).astype(np.int32)
             for n in (5, 9)]
    for rid, tail in enumerate(tails, start=2):
        sched.submit(GenerateRequest(
            rid=rid, prompt=np.concatenate([text, tail]), max_new_tokens=3))
        sched.run_to_completion()
    assert sched.prefix_hits == 1 and sched.prefix_hit_tokens == 32
    got = {r.rid: r for r in sched.results}
    assert got[3].cached_len == 32
    for rid, tail in enumerate(tails, start=2):
        assert got[rid].tokens == lockstep_generate(
            eng, np.concatenate([text, tail]), 3), rid


def test_submit_counts_the_image_prefix(engines):
    """16 image rows + 40 text + 9 new = 65 > capacity 64 is refused at
    submit; the same request without its image fits; patches on a dense
    engine are refused."""
    sched = Scheduler(engines[True], n_slots=1)
    req = _requests(lens=(40,), gen=9)[0]
    with pytest.raises(ValueError, match="pool capacity"):
        sched.submit(req)
    assert sched.submit(GenerateRequest(rid=1, prompt=req.prompt,
                                        max_new_tokens=9))
    dense = PooledEngine.from_seed(get_config("bitnet-3b-reduced"), seed=0,
                                   max_len=MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="patches"):
        Scheduler(dense, n_slots=1).submit(req)
    assert not Scheduler(dense, n_slots=1).engine.prefix_len(req)
