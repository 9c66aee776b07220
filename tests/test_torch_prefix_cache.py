"""Prefix caching on the port (``tests/test_prefix_cache.py``'s contracts),
on ``bitnet-3b-reduced`` with the reference's converted weights, on the
CPU:

  * the hash-chain store: strict-prefix, token-checked matching, the
    assemble round trip, ref-counted LRU eviction leaf first — each also
    held to the reference's store under the same operations;
  * the store's pages are clones: evicting, re-prefilling or rolling back
    the lane they came from leaves them bitwise intact;
  * the device checksum changes for every single flipped bit of every
    leaf (first, middle and tail bytes, all 8 bits);
  * ``bulk_insert`` is bitwise the reference's, into fresh and evicted
    lanes and node by node at each node's offset, in place (no pool
    tensor rebound);
  * the scheduler: mixed hit and miss traffic is the reference scheduler's
    (tokens, hits, cached lengths, prefill tokens computed and served) and
    each stream is the cache-off lockstep stream; sharers admitted in one
    sweep miss, a later wave hits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.bitnet_3b import REDUCED as JCFG
from repro.models.transformer import init_params as jinit
from repro.serving import cache as jcache
from repro.serving.quantize import quantize_params as jquantize
from repro.serving.scheduler import Request as JRequest
from repro.serving.scheduler import Scheduler as JScheduler
from repro_torch.configs import get_config
from repro_torch.convert import from_numpy_tree
from repro_torch.serving import cache
from repro_torch.serving.api import ExistingPrefix, GenerateRequest, \
    PooledEngine
from repro_torch.serving.scheduler import Scheduler, lockstep_generate

torch.set_num_threads(1)

MAX_LEN = 63          # pool capacity 64 with the reduced lop_block of 32
CFG = get_config("bitnet-3b-reduced")


@pytest.fixture(scope="module")
def weights():
    params, _ = jinit(JCFG, jax.random.PRNGKey(0))
    jqp = jquantize(JCFG, params)
    return jqp, from_numpy_tree(jax.tree.map(np.asarray, jqp), "cpu")


@pytest.fixture(scope="module")
def eng(weights):
    return PooledEngine(CFG, weights[1], max_len=MAX_LEN, use_lop=False,
                        device="cpu")


def _prompts(lens, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab, (n,)).astype(np.int32) for n in lens]


def _tensors(tree, prefix=""):
    for name, val in sorted(tree.items()):
        if isinstance(val, dict):
            yield from _tensors(val, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", val


def _to_numpy(tree):
    return {k: _to_numpy(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


def _assert_trees_equal(port, ref):
    ref = jax.tree.map(np.asarray, ref)
    got = dict(_tensors(port))
    want = dict(_tensors(ref))
    assert sorted(got) == sorted(want)
    for name, leaf in want.items():
        assert got[name].numpy().dtype == leaf.dtype, name
        np.testing.assert_array_equal(got[name].numpy(), leaf, err_msg=name)


# ---------------------------------------------------------------------------
# the store (host control structure; pages on the device)
# ---------------------------------------------------------------------------

def _fake_cache(n_tokens, layers=2):
    """Batch-1 cache in the port's layout with recognizable per-position
    bytes; the reference's twin drops the layer axis, as its own test's."""
    k = torch.arange(n_tokens, dtype=torch.int8)[None, None, None, :, None]
    ks = torch.arange(n_tokens, dtype=torch.float32)[None, None, None, :]
    port = {"lengths": torch.full((1,), n_tokens, dtype=torch.int32),
            "layers": {
                "k": k.expand(layers, 1, CFG.n_kv_heads, n_tokens,
                              CFG.hd).contiguous(),
                "k_scale": ks.expand(layers, 1, CFG.n_kv_heads,
                                     n_tokens).contiguous()}}
    ref = {"lengths": jnp.full((1,), n_tokens, jnp.int32),
           "layers": {"k": jnp.asarray(port["layers"]["k"][0].numpy()),
                      "k_scale": jnp.asarray(
                          port["layers"]["k_scale"][0].numpy())}}
    return port, ref


def _both(port_store, ref_store, call, *args):
    got = getattr(port_store, call)(*args)
    want = getattr(ref_store, call)(*args)
    return got, want


def test_store_match_is_strict_prefix_and_token_checked():
    rng = np.random.default_rng(7)
    store, jstore = cache.PrefixStore(32), jcache.PrefixStore(32)
    toks = rng.integers(0, CFG.vocab, (64,)).astype(np.int32)
    assert _both(store, jstore, "match", toks) == ((0, None), (0, None))
    port_c, ref_c = _fake_cache(64)
    store.insert(toks, port_c)
    jstore.insert(toks, ref_c)
    assert store.cached_tokens == jstore.cached_tokens == 64
    longer = np.concatenate([toks, toks[:5]])
    div = toks.copy()
    div[0] = (div[0] + 1) % CFG.vocab
    div2 = toks.copy()
    div2[40] = (div2[40] + 1) % CFG.vocab
    cases = [(toks, 32), (longer, 64),
             (np.concatenate([div, toks[:5]]), 0),
             (np.concatenate([div2, toks[:5]]), 32)]
    for prompt, want in cases:
        (n, node), (jn, _) = _both(store, jstore, "match", prompt)
        assert n == jn == want
        assert (node is None) == (want == 0)
        if node is not None:
            assert node.n_tokens == want
    assert store.hits == jstore.hits and store.misses == jstore.misses
    assert not store.missing(toks)
    assert store.missing(np.concatenate([toks, toks[:32]]))
    store.check_invariants()


def test_store_assemble_round_trips_pages():
    rng = np.random.default_rng(8)
    store = cache.PrefixStore(32)
    toks = rng.integers(0, CFG.vocab, (64,)).astype(np.int32)
    port_c, _ = _fake_cache(64)
    store.insert(toks, port_c)
    _, node = store.match(np.concatenate([toks, toks[:1]]))
    out = store.assemble(node)
    assert torch.equal(out["lengths"], port_c["lengths"])
    for key, leaf in port_c["layers"].items():
        assert torch.equal(out["layers"][key], leaf), key
        # the store's pages are its own
        assert out["layers"][key].data_ptr() != leaf.data_ptr()


def test_store_lru_eviction_is_ref_counted_leaf_first():
    rng = np.random.default_rng(9)
    store = cache.PrefixStore(32, max_tokens=96)
    jstore = jcache.PrefixStore(32, max_tokens=96)
    a = rng.integers(0, CFG.vocab, (64,)).astype(np.int32)      # chain A: 2
    b = rng.integers(0, CFG.vocab, (32,)).astype(np.int32)      # chain B: 1
    c = rng.integers(0, CFG.vocab, (32,)).astype(np.int32)
    for toks in (a, b):
        port_c, ref_c = _fake_cache(len(toks))
        store.insert(toks, port_c)
        jstore.insert(toks, ref_c)
    assert store.cached_tokens == 96
    _both(store, jstore, "match", np.concatenate([b, b[:1]]))   # touch B
    port_c, ref_c = _fake_cache(32)
    store.insert(c, port_c)                                     # over budget
    jstore.insert(c, ref_c)
    assert store.cached_tokens == 96 and store.evictions == 1
    assert jstore.evictions == 1
    # A's leaf went (its root block has a child); A still matches one
    # block, B is intact
    for toks in (a, b):
        (n, _), (jn, _) = _both(store, jstore, "match",
                                np.concatenate([toks, toks[:1]]))
        assert n == jn == 32
    assert store.nbytes == 3 * sum(
        leaf[:, :, :, :32].numel() * leaf.element_size()
        for leaf in port_c["layers"].values())
    store.check_invariants()


# ---------------------------------------------------------------------------
# the checksum on the pages' device, and the pages as clones
# ---------------------------------------------------------------------------

def _real_pages(eng, n_tokens=32, seed=21):
    (p,) = _prompts([n_tokens + 5], seed)
    _, c = eng.prefill(p[None])
    return p, c


@pytest.mark.parametrize("leaf", ["feat", "k", "k_scale", "v", "v_scale"])
def test_checksum_catches_every_single_bit(eng, leaf):
    _, c = _real_pages(eng)
    pages = cache._slice_pages(c, 0, 32)
    base = cache._page_checksum(pages)
    assert torch.equal(cache._page_checksum(pages), base)
    flat = pages["layers"][leaf].reshape(-1).view(torch.uint8)
    n = flat.numel()
    for byte in sorted({0, 1, n // 2, n - cache._ROW_BYTES - 1,
                        n - 2, n - 1} & set(range(n))):
        for bit in range(8):
            flat[byte:byte + 1].bitwise_xor_(1 << bit)
            assert not torch.equal(cache._page_checksum(pages), base), \
                (leaf, byte, bit)
            flat[byte:byte + 1].bitwise_xor_(1 << bit)
    assert torch.equal(cache._page_checksum(pages), base)


def test_interned_pages_survive_the_lanes_later_life(eng):
    """Pages are clones: evicting the lane they were interned from,
    prefilling another prompt into it and rolling it back leave the store
    bitwise as interned, and its next match verifies clean."""
    store = cache.PrefixStore(eng.prefix_block)
    p, c = _real_pages(eng, 32, seed=22)
    pool = eng.init_pool(2)
    pool = eng.insert(pool, 1, c)
    store.insert(p[:32], cache.extract_slot(pool, 1))
    _, node = store.match(p)
    snap = {k: v.clone() for k, v in store.assemble(node)["layers"].items()}
    (q,) = _prompts([50], seed=23)
    pool = eng.evict(pool, 1)
    _, other = eng.prefill(q[None])
    pool = eng.insert(pool, 1, other)
    pool = eng.rollback(pool, 1, 30)
    n, node = store.match(p)
    assert n == 32 and store.checksum_failures == 0
    for key, leaf in store.assemble(node)["layers"].items():
        assert torch.equal(leaf, snap[key]), key


# ---------------------------------------------------------------------------
# bulk_insert, bitwise the reference's
# ---------------------------------------------------------------------------

def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, _to_numpy(tree))


def test_bulk_insert_bitwise_reference(eng):
    """One batch-1 prefill cloned into lanes 1 and 3 of a 4-lane pool:
    K/V pages, scales, LOP feature rows, lengths and active land as the
    reference's scatter lands them, per-lane seeds survive, and no pool
    tensor is rebound."""
    (p,) = _prompts([37], seed=11)
    _, rc = eng.prefill(p[None])
    pool = eng.init_pool(4)
    pool["seed"].copy_(torch.arange(4, dtype=torch.int32))
    jpool = _jax_tree(pool)
    ptrs = {name: t.data_ptr() for name, t in _tensors(pool)}
    got = cache.bulk_insert(pool, [1, 3], rc, active=False)
    want = jcache.bulk_insert(jpool, jnp.asarray([1, 3], jnp.int32),
                              _jax_tree(rc), active=False)
    _assert_trees_equal(got, want)
    assert {name: t.data_ptr() for name, t in _tensors(pool)} == ptrs
    assert pool["seed"].tolist() == [0, 1, 2, 3]
    assert not pool["active"].any()


def test_bulk_insert_into_evicted_lane_bitwise_reference(eng):
    """A prefix (shorter than the pool's capacity) cloned into a lane a
    previous occupant dirtied == the reference's, and its feature rows ==
    a clone into a fresh pool (the evict feat-zeroing invariant)."""
    dirty_p, p = _prompts([45, 40], seed=12)
    _, dirty = eng.prefill(dirty_p[None])
    store = cache.PrefixStore(eng.prefix_block)
    _, c = eng.prefill(p[None])
    store.insert(p[:32], c)
    prefix = store.assemble(store.match(p)[1])
    assert prefix["layers"]["k"].shape[3] == 32
    pool = eng.init_pool(2)
    pool = eng.insert(pool, 0, dirty)
    pool = eng.evict(pool, 0)
    jpool = _jax_tree(pool)
    reused = eng.bulk_insert(pool, [0], ExistingPrefix(prefix, 32))
    want = jcache.bulk_insert(jpool, jnp.asarray([0], jnp.int32),
                              _jax_tree(prefix), active=False)
    _assert_trees_equal(reused, want)
    fresh = eng.bulk_insert(eng.init_pool(2), [0], ExistingPrefix(prefix, 32))
    assert torch.equal(reused["layers"]["feat"], fresh["layers"]["feat"])
    assert torch.equal(reused["lengths"], fresh["lengths"])
    assert cache.free_slots(reused) == [0, 1]


def test_bulk_insert_node_by_node_equals_reference_assembled(eng):
    """A three-node chain written into two dirtied lanes node by node, each
    at its own token offset (the scheduler's hit path), == the reference's
    one scatter of the whole assembled prefix, and no pool tensor is
    rebound."""
    dirty_p, p = _prompts([45, 52], seed=18)
    _, dirty = eng.prefill(dirty_p[None])
    store = cache.PrefixStore(16)
    _, c = eng.prefill(p[None])
    node = store.insert(p[:48], c)
    chain = store.chain(node)
    assert [n.n_tokens for n in chain] == [16, 32, 48]
    pool = eng.init_pool(3)
    for slot in (0, 2):
        pool = eng.insert(pool, slot, dirty)
        pool = eng.evict(pool, slot)
    jpool = _jax_tree(pool)
    ptrs = {name: t.data_ptr() for name, t in _tensors(pool)}
    for n in chain:
        pool = eng.bulk_insert(pool, [0, 2], ExistingPrefix(n.pages,
                                                            n.n_tokens),
                               start=n.n_tokens - 16)
    want = jcache.bulk_insert(jpool, jnp.asarray([0, 2], jnp.int32),
                              _jax_tree(store.assemble(node)), active=False)
    _assert_trees_equal(pool, want)
    assert {name: t.data_ptr() for name, t in _tensors(pool)} == ptrs
    assert pool["lengths"].tolist() == [48, 0, 48]


# ---------------------------------------------------------------------------
# the scheduler: hits and misses, against the reference and cache-off
# ---------------------------------------------------------------------------

def test_scheduler_mixed_hit_miss_matches_reference_and_cache_off(
        weights, eng):
    """A prefix-hit request admitted beside cold ones decodes as the
    reference scheduler does, counter for counter, and as the cache-off
    lockstep stream."""
    jqp, _ = weights
    rng = np.random.default_rng(13)
    shared = rng.integers(0, CFG.vocab, (32,)).astype(np.int32)
    prompts = ([np.concatenate([shared, s])
                for s in _prompts([9, 14, 5], seed=14)]
               + _prompts([11, 26], seed=15))
    # 1 lane: sharers admit strictly after the first one interned
    sched = Scheduler(eng, n_slots=1, check_invariants=True)
    jsched = JScheduler(JCFG, jqp, n_slots=1, max_len=MAX_LEN, use_lop=False)
    assert sched.prefix_store is not None
    for rid, p in enumerate(prompts):
        sched.submit(GenerateRequest(rid=rid, prompt=p, max_new_tokens=6))
        jsched.submit(JRequest(rid=rid, prompt=p, max_new_tokens=6))
    res = {r.rid: r for r in sched.run_to_completion()}
    jres = {r.rid: r for r in jsched.run_to_completion()}
    for name in ("prefix_hits", "prefix_hit_tokens",
                 "prefill_tokens_computed", "prefill_tokens_served"):
        assert getattr(sched, name) == getattr(jsched, name), name
    assert sched.prefix_hits == 2 and sched.prefix_hit_tokens == 64
    assert [res[r].cached_len for r in range(5)] == [0, 32, 32, 0, 0]
    assert sched.prefill_tokens_served == sched.prefill_tokens_computed + 64
    for rid, p in enumerate(prompts):
        assert res[rid].tokens == [int(t) for t in jres[rid].tokens], rid
        assert res[rid].cached_len == jres[rid].cached_len
        assert res[rid].tokens == lockstep_generate(eng, p, 6), rid


def test_scheduler_same_sweep_sharers_hit_after_interning(eng):
    """Sharers admitted in ONE sweep all miss an empty store; the next
    wave hits the interned prefix; hits admitted in one sweep are cloned
    by one bulk_insert a chain node."""
    rng = np.random.default_rng(16)
    shared = rng.integers(0, CFG.vocab, (32,)).astype(np.int32)
    prompts = [np.concatenate([shared, s])
               for s in _prompts([7, 10, 8, 12, 9, 6], seed=17)]
    sched = Scheduler(eng, n_slots=2, check_invariants=True)
    for rid, p in enumerate(prompts[:4]):
        sched.submit(GenerateRequest(rid=rid, prompt=p, max_new_tokens=5))
    sched.run_to_completion()
    calls = []
    bulk = eng.bulk_insert

    def spy(pool, slots, prefix, active=False, start=0):
        calls.append((list(slots), start))
        return bulk(pool, slots, prefix, active, start)

    eng.bulk_insert = spy
    try:
        for rid in (4, 5):
            sched.submit(GenerateRequest(rid=rid, prompt=prompts[rid],
                                         max_new_tokens=5))
        res = {r.rid: r for r in sched.run_to_completion()}
    finally:
        del eng.bulk_insert
    # wave 1 (rids 0, 1) cold; every later request hits
    assert sched.prefix_hits == 4 and calls == [([0, 1], 0)]
    assert [res[r].cached_len for r in range(6)] == [0, 0, 32, 32, 32, 32]
    off = Scheduler(eng, n_slots=2, prefix_cache=False)
    assert off.prefix_store is None
    for rid, p in enumerate(prompts):
        off.submit(GenerateRequest(rid=rid, prompt=p, max_new_tokens=5))
    cold = {r.rid: r for r in off.run_to_completion()}
    for rid in range(6):
        assert res[rid].tokens == cold[rid].tokens, rid
        assert cold[rid].cached_len == 0


def test_admit_returns_the_count_with_prefix_hits(eng):
    """``admit`` returns how many requests it admitted, as the
    reference's does, also when hits clone chain nodes in that sweep."""
    rng = np.random.default_rng(18)
    shared = rng.integers(0, CFG.vocab, (32,)).astype(np.int32)
    prompts = [np.concatenate([shared, s])
               for s in _prompts([7, 10, 8], seed=19)]
    sched = Scheduler(eng, n_slots=2, check_invariants=True)
    sched.submit(GenerateRequest(rid=0, prompt=prompts[0], max_new_tokens=3))
    assert sched.admit() == 1
    sched.run_to_completion()
    for rid in (1, 2):
        sched.submit(GenerateRequest(rid=rid, prompt=prompts[rid],
                                     max_new_tokens=3))
    assert sched.admit() == 2
    assert sched.prefix_hits == 2
    sched.run_to_completion()
