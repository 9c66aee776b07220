"""Serving caches: int8 K/V + absmax scales + packed LOP features.

The cache is a dict of tensors: ``lengths`` int32 [B] and, per layer-stacked
leaf, ``layers.k``/``layers.v`` int8 [L, B, Hkv, M, dh], ``k_scale``/
``v_scale`` f32 [L, B, Hkv, M] and ``feat`` uint8 [L, B, Hkv, M, dh//2].
Capacity M is block-aligned (``lop_block``). A recurrent family keeps
its state in the same tree: ssm (rwkv6) ``layers.wkv`` f32 [L, B, H, dh,
dh] and ``layers.x_tm``/``x_cm`` f32 [L, B, 1, D], and no pages; hybrid
(jamba) ``blocks.attn`` (the five page leaves stacked over the
superblocks) and ``blocks.mamba.ssm`` f32 [n_sb, attn_every − 1, B, Di, S]
and ``blocks.mamba.conv`` [n_sb, attn_every − 1, B, ck − 1, Di], whose
slot axis is 2. An encdec cache adds the
cross-attention pages ``cross`` (the same five leaves over the encoder
memory, capacity ``round_up(cross_ctx, lop_block)``, written once at
prefill and never by a decode step) and each lane's encoder length
``cross_len`` int32 [B]. A slot-paged pool adds an
``active`` bool [B] mask and each lane's sampling state, ``seed`` and
``sample_step`` int32 [B] (the PRNG schedule travels with the lane).

Unlike the reference's functional updates, these operations write the
pool in place: ``insert_slot`` copies a batch-1 cache into a lane,
``extract_slot`` returns *views* of a lane (so a chunked-prefill step that
writes its chunk into the extracted lane writes the pool itself), and
``evict_slot`` retires a lane and ``rollback_slot`` rewinds one; each
finds a leaf's slot axis from its name and rank, as the reference's
``slot_axis`` does. Bytes above a lane's length are stale and masked by
every reader.

Prefix caching: :class:`PrefixStore` interns computed prefill pages keyed
by token-block hash chains (block ``k`` of a prompt is keyed by
``blake2b(parent_key ‖ tokens of block k)``), so equal prompt prefixes —
and only those — share a chain of nodes, each holding that block's K/V,
scales and packed LOP feature rows. The pages stay on the device, each
node's a clone of its own (never a view of a pool lane, which a later
prefill, eviction or rollback would rewrite), and so do their checksums.
``bulk_insert`` clones one assembled prefix into many lanes with one
write a leaf; the scheduler then resumes chunked prefill at the cached
block boundary.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from repro_torch.models.mamba import mamba_state_shape
from repro_torch.models.rwkv6 import rwkv_state_shape
from repro_torch.serving import faults as _faults

_LEAVES = ("k", "v", "k_scale", "v_scale", "feat")


def round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def capacity_for(cfg, max_len: int, align: int | None = None) -> int:
    """Token capacity for ``max_len`` tokens plus one decode slot, a
    multiple of ``align`` (default ``lop_block``; sequence-parallel decode
    aligns it to the shard count × block, so every shard holds whole
    blocks)."""
    return round_up(max_len + 1, align or cfg.lop_block)


def cross_capacity_for(cfg, frames: int = 0, align: int | None = None) -> int:
    """Token capacity of an encdec cache's cross-attention pages: the
    roundup of ``cross_ctx`` to ``align`` (default ``lop_block``), or of
    ``frames`` when that is more (a prefill of a longer encoder input, as
    the reference sizes it)."""
    return round_up(max(cfg.cross_ctx, frames), align or cfg.lop_block)


# how each served family keeps its per-sequence state (the reference's
# ``_STATE_KINDS``): dense, moe and vlm layers keep one paged K/V cache (a
# vlm image prefix takes the lane's first positions); encdec
# adds the encoder memory's cross-attention pages; ssm (rwkv6) keeps a
# recurrent state a layer and no pages; hybrid (jamba) keeps one page
# tree a superblock beside its Mamba sublayers' states
STATE_KINDS = {"dense": "paged-kv", "moe": "paged-kv", "vlm": "paged-kv",
               "encdec": "paged-kv+cross", "ssm": "recurrent",
               "hybrid": "hybrid"}

# each leaf's rank below its stacked leading axes (the reference's
# ``_leaf_spec``): a leaf's slot axis is its ndim less this rank, so 1 for
# pages and rwkv6 states ([L, B, ...]) and 2 for Mamba states ([n_sb,
# n_mamba, B, ...]); the per-lane vectors' slot axis is 0
_LEAF_RANK = {"k": 4, "v": 4, "feat": 4, "k_scale": 3, "v_scale": 3,
              "wkv": 4, "x_tm": 3, "x_cm": 3, "ssm": 3, "conv": 3}
_PER_LANE = ("lengths", "cross_len", "active", "seed", "sample_step")


def slot_axis(name: str, leaf: torch.Tensor) -> int:
    """Index of the slot (batch) axis of the cache leaf ``name``."""
    return 0 if name in _PER_LANE else leaf.ndim - _LEAF_RANK[name]


def _leaf_spec(name: str, *, batch_axes="dp", seq_axes="sp") -> tuple:
    """Logical axes of one cache leaf from its slot axis on (the
    reference's ``_leaf_spec``): pages cut their token axis over
    ``seq_axes``, recurrent states their heads or inner width over
    ``tp``, and the per-lane vectors stay whole."""
    if name in ("k", "v", "feat"):
        return (batch_axes, None, seq_axes, None)
    if name in ("k_scale", "v_scale"):
        return (batch_axes, None, seq_axes)
    if name in _PER_LANE:
        return (None,)
    if name == "ssm":
        return (batch_axes, "tp", None)
    if name == "conv":
        return (batch_axes, None, "tp")
    if name == "wkv":
        return (batch_axes, "tp", None, None)
    if name in ("x_tm", "x_cm"):
        return (batch_axes, None, None)
    raise KeyError(name)


def cache_pspecs(cfg, cache, *, batch_axes="dp", seq_axes="sp") -> dict:
    """The logical-axis tree of a cache (the reference's
    ``cache_pspecs``): each leaf's spec from its slot axis, after a None
    for every stacked leading axis (layers, superblocks, sublayers)."""
    del cfg

    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        spec = _leaf_spec(name, batch_axes=batch_axes, seq_axes=seq_axes)
        return (None,) * (node.ndim - len(spec)) + spec
    return walk(cache, None)


def _tree_leaves(tree, path=()):
    """(path, leaf) of every tensor of a nested dict, in insertion order."""
    for name, val in tree.items():
        if isinstance(val, dict):
            yield from _tree_leaves(val, path + (name,))
        else:
            yield path + (name,), val


def _at(tree, path):
    for name in path:
        tree = tree[name]
    return tree


def _attn_zeros(cfg, batch: int, cap: int, device, n: int | None = None
                ) -> dict:
    """The five zero leaves of an attention cache, [n, B, Hkv, cap, ...]
    (n the layer count by default)."""
    lead = (cfg.n_layers if n is None else n, batch, cfg.n_kv_heads, cap)
    dh = cfg.hd
    return {
        "k": torch.zeros((*lead, dh), dtype=torch.int8, device=device),
        "v": torch.zeros((*lead, dh), dtype=torch.int8, device=device),
        "k_scale": torch.zeros(lead, dtype=torch.float32, device=device),
        "v_scale": torch.zeros(lead, dtype=torch.float32, device=device),
        "feat": torch.zeros((*lead, dh // 2), dtype=torch.uint8,
                            device=device),
    }


def _zeros(lead: tuple, shapes: dict, device) -> dict:
    """Zero state leaves of ``shapes`` (name → (shape, dtype)) under the
    stacked axes ``lead``."""
    return {name: torch.zeros((*lead, *shape), dtype=dtype, device=device)
            for name, (shape, dtype) in shapes.items()}


def init_cache(cfg, batch: int, max_len: int, device,
               frames: int = 0, align: int | None = None) -> dict:
    """Zero cache for ``batch`` sequences of up to ``max_len`` tokens (an
    encdec cache's cross pages hold ``max(cross_ctx, frames)``), each
    capacity a multiple of ``align`` (the reference's; default
    ``lop_block``). An ssm
    cache holds each layer's rwkv6 state (``layers.{wkv, x_tm, x_cm}``) and
    no pages; a hybrid cache holds ``blocks.attn`` pages stacked over the
    superblocks and ``blocks.mamba.{ssm, conv}`` [n_sb, attn_every − 1, B,
    ...]."""
    kind = STATE_KINDS[cfg.family]
    cache = {"lengths": torch.zeros(batch, dtype=torch.int32, device=device)}
    cap = capacity_for(cfg, max_len, align)
    if kind == "recurrent":
        cache["layers"] = _zeros((cfg.n_layers,),
                                 rwkv_state_shape(cfg, batch), device)
        return cache
    if kind == "hybrid":
        n_sb = cfg.n_layers // cfg.attn_every
        cache["blocks"] = {
            "attn": _attn_zeros(cfg, batch, cap, device, n=n_sb),
            "mamba": _zeros((n_sb, cfg.attn_every - 1),
                            mamba_state_shape(cfg, batch), device)}
        return cache
    cache["layers"] = _attn_zeros(cfg, batch, cap, device)
    if kind == "paged-kv+cross":
        cache["cross"] = _attn_zeros(cfg, batch,
                                     cross_capacity_for(cfg, frames, align),
                                     device)
        cache["cross_len"] = torch.zeros(batch, dtype=torch.int32,
                                         device=device)
    return cache


def init_cache_pool(cfg, n_slots: int, max_len: int, device) -> dict:
    """Slot-paged pool: ``n_slots`` persistent decode lanes, all inactive."""
    pool = init_cache(cfg, n_slots, max_len, device)
    pool["active"] = torch.zeros(n_slots, dtype=torch.bool, device=device)
    pool["seed"] = torch.zeros(n_slots, dtype=torch.int32, device=device)
    pool["sample_step"] = torch.zeros(n_slots, dtype=torch.int32,
                                      device=device)
    return pool


def pool_capacity(pool) -> int:
    """Token capacity of the pool's self-attention lanes (0 for an
    attention-free pool, which has no token bound)."""
    for path, leaf in _tree_leaves(pool):
        if path[-1] == "k" and "cross" not in path:
            return leaf.shape[slot_axis("k", leaf) + 2]
    return 0


def pool_cross_capacity(pool) -> int:
    """Token capacity of the pool's cross-attention lanes (0 without)."""
    return pool["cross"]["k"].shape[3] if "cross" in pool else 0


def insert_slot(pool, slot: int, req_cache, active: bool = True) -> dict:
    """Copy a batch-1 cache into lane ``slot`` (in place): every page and
    state leaf at its own slot axis, ``lengths`` and ``cross_len``.

    The request cache's token capacity may be smaller than the pool's
    (each page tree against its own); positions above it keep stale bytes,
    masked by ``lengths`` (``cross_len``). Copying a lane onto itself (an
    ``extract_slot`` view) is skipped.
    """
    for path, src in _tree_leaves(req_cache):
        name = path[-1]
        if name in ("lengths", "cross_len"):
            pool[name][slot] = src[0]
        elif name not in _PER_LANE:
            dst = _at(pool, path)
            ax = slot_axis(name, dst)
            d, s = dst.select(ax, slot), src.select(ax, 0)
            if d.data_ptr() != s.data_ptr():
                d[tuple(slice(0, n) for n in s.shape)].copy_(s)
    pool["active"][slot] = active
    return pool


def bulk_insert(pool, slots, req_cache, active: bool = True,
                start: int = 0) -> dict:
    """Clone ONE batch-1 cache into the lanes ``slots`` (in place): one
    indexed write a leaf, the cache's size-1 slot axis broadcast over the
    lanes. A leaf shorter than the pool's along the token axis (a prefix
    holds its own block-aligned length) writes its own extent at token
    positions ``[start, start + extent)`` — a prefix chain goes in node by
    node, each at its own offset, with no concatenated copy; positions
    outside keep the lane's bytes (zero for feature rows after
    ``evict_slot``, masked everywhere else). Per-lane vectors the cache
    does not carry (``lengths``, ``seed``, ``sample_step``) keep their
    pool values. Prefix clones land with ``active=False``: they are
    reservations that resume chunked prefill from the cached boundary. No
    pool tensor is rebound."""
    idx = torch.as_tensor(np.asarray(slots, np.int64),
                          device=pool["lengths"].device)
    for key, src in req_cache["layers"].items():
        pool["layers"][key][:, idx, :, start:start + src.shape[3]] = src
    for key in ("lengths", "seed", "sample_step"):
        if key in req_cache:
            pool[key][idx] = req_cache[key].to(pool[key].dtype)
    pool["active"][idx] = active
    return pool


def free_slots(pool) -> list[int]:
    """Lanes not active now, on the host (syncs). A lane reserved for a
    prompt mid-prefill is inactive too; the scheduler tracks those."""
    return [int(i) for i in np.flatnonzero(~pool["active"].cpu().numpy())]


def extract_slot(pool, slot: int) -> dict:
    """Batch-1 *views* of lane ``slot`` (``lengths``, ``cross_len``, and
    every page and state leaf): writes through them land in the pool
    (chunked prefill writes its chunk's K/V this way)."""
    def lane(tree):
        out = {}
        for name, val in tree.items():
            if isinstance(val, dict):
                out[name] = lane(val)
            elif name not in ("active", "seed", "sample_step"):
                out[name] = val.narrow(slot_axis(name, val), slot, 1)
        return out
    return lane(pool)


def evict_slot(pool, slot: int) -> dict:
    """Retire lane ``slot`` (in place): inactive, length 0, and its packed
    LOP feature rows zeroed in every page tree (the pool-init bit
    pattern), the cross pages' too; ``cross_len`` and recurrent state
    stay, as in the reference (an inactive lane's are never read, and an
    insert overwrites them)."""
    for path, leaf in _tree_leaves(pool):
        if path[-1] == "feat":
            leaf.select(slot_axis("feat", leaf), slot).zero_()
    pool["active"][slot] = False
    pool["lengths"][slot] = 0
    return pool


def rollback_slot(pool, slot: int, n: int) -> dict:
    """Rewind lane ``slot`` by ``n`` appended tokens (in place).

    ``lengths`` drops by ``n`` (clamped at 0) and the rows
    ``[lengths − n, lengths)`` of k/v/k_scale/v_scale/feat of every
    self-attention page tree are zeroed, so the lane is bit for bit its
    pool-init pattern there; ``sample_step`` rewinds by ``n`` too (clamped
    at 0), keeping a sampled lane's key schedule aligned with its emission
    count. Cross pages and recurrent state are left as they are, as in
    the reference: a recurrent state cannot rewind, so a rolled-back lane
    of an ssm or hybrid pool steps on from its advanced state.
    """
    old = int(pool["lengths"][slot])
    new = max(old - n, 0)
    for path, leaf in _tree_leaves(pool):
        if path[-1] in _LEAVES and "cross" not in path:
            ax = slot_axis(path[-1], leaf)
            leaf.select(ax, slot).narrow(ax + 1, new, old - new).zero_()
    pool["lengths"][slot] = new
    if "sample_step" in pool:
        pool["sample_step"][slot] = torch.clamp_min(
            pool["sample_step"][slot] - n, 0)
    return pool


# ---------------------------------------------------------------------------
# Prefix store (hash-chain interning of computed prefill pages)
# ---------------------------------------------------------------------------

# words a checksum row sums: 4096 int32 words fit an int64 sum exactly
_ROW_BYTES = 4 * 4096


def _chain_key(parent_key: bytes, block_tokens: np.ndarray) -> bytes:
    """Hash-chain key of one token block given its parent's key."""
    h = hashlib.blake2b(parent_key, digest_size=16)
    h.update(np.ascontiguousarray(block_tokens, np.int32).tobytes())
    return h.digest()


def _leaves(pages):
    """A page tree's leaves in sorted-path order (``jax.tree.flatten``'s
    order for the reference's dict of the same keys)."""
    for name in sorted(pages):
        val = pages[name]
        if isinstance(val, dict):
            yield from _leaves(val)
        else:
            yield val


def _page_checksum(pages) -> torch.Tensor:
    """Content checksum of one node's pages, computed on their device.

    Each leaf's bytes, in order, are cut into rows of 16 KiB; a row's
    checksum is the exact int64 sum of its int32 words (a tail shorter
    than a row sums its bytes). One flipped bit changes its row's sum by
    ±2^b, never by 0, so any single flipped bit in any leaf changes the
    checksum. → int64 [rows over every leaf]; taken at intern, compared
    at every match.
    """
    sums = []
    for leaf in _leaves(pages):
        flat = leaf.reshape(-1).view(torch.uint8)
        full = flat.numel() // _ROW_BYTES * _ROW_BYTES
        sums.append(flat[:full].view(torch.int32).view(-1, _ROW_BYTES // 4)
                    .sum(dim=1, dtype=torch.int64))
        sums.append(flat[full:].sum(dtype=torch.int64).reshape(1))
    return torch.cat(sums)


def _flip_one_bit(pages, rng) -> None:
    """Flip one bit of a page tree in place (the injected post-intern
    corruption of :mod:`repro_torch.serving.faults`). The leaf, byte and
    bit are drawn from ``rng`` as the reference draws them, over the same
    leaves in the same order and the same little-endian bytes."""
    leaves = list(_leaves(pages))
    i = int(rng.integers(0, len(leaves)))
    flat = leaves[i].reshape(-1).view(torch.uint8)
    byte = int(rng.integers(0, flat.numel()))
    flat[byte:byte + 1].bitwise_xor_(1 << int(rng.integers(0, 8)))


def _slice_pages(cache, lo: int, hi: int) -> dict:
    """Token range [lo, hi) of every positional leaf of a batch-1 cache,
    as contiguous clones: the store owns its pages, so nothing done to the
    lane later reaches them."""
    return {"layers": {
        key: leaf[:, :, :, lo:hi].clone(memory_format=torch.contiguous_format)
        for key, leaf in cache["layers"].items()}}


def _concat_pages(trees) -> dict:
    """Per-block page trees concatenated along each leaf's token axis (one
    block: its own tensors, which the caller only reads)."""
    if len(trees) == 1:
        return {"layers": dict(trees[0]["layers"])}
    return {"layers": {key: torch.cat([t["layers"][key] for t in trees],
                                      dim=3)
                       for key in trees[0]["layers"]}}


class _PrefixNode:
    """One interned token block: its pages and its place in the chain.

    ``refs`` is the node's child count: a parent's pages stay live while
    any longer chain extends through it, so only childless nodes are
    eviction candidates.
    """

    __slots__ = ("key", "parent", "tokens", "n_tokens", "pages",
                 "children", "last_use", "checksum")

    def __init__(self, key, parent, tokens, n_tokens, pages,
                 checksum=None):
        self.key = key
        self.parent = parent
        self.tokens = tokens
        self.n_tokens = n_tokens           # cumulative tokens through here
        self.pages = pages
        self.children: dict = {}
        self.last_use = 0
        self.checksum = checksum           # of the pages at intern

    @property
    def refs(self) -> int:
        return len(self.children)


class PrefixStore:
    """Hash/radix-keyed intern table over block-aligned cache pages.

    The control structure is on the host; the pages and their checksums
    stay on the device. Block ``k`` of a prompt is keyed by
    ``blake2b(parent_key ‖ int32 tokens of block k)`` — a chain, so two
    prompts share node ``k`` iff their first ``(k+1)·block`` tokens are
    equal; stored tokens are compared on every walk, so a hash collision
    is a miss.

    ``match`` finds the longest *strict*-prefix chain of a prompt (one
    suffix token must remain for the first-token logits) and verifies its
    pages' checksums; ``insert`` interns a computed batch-1 prefill's
    pages block by block (existing nodes are shared, not rewritten);
    ``chain`` lists a match's nodes root first, for :func:`bulk_insert` to
    write node by node, and ``assemble`` concatenates their pages into one
    batch-1 cache.

    Eviction is ref-counted LRU against ``max_tokens``: only childless
    nodes retire, oldest ``last_use`` first, so a chain ages out leaf to
    root. Matching bumps the whole ancestry's recency.
    """

    def __init__(self, block: int, *, max_tokens: int | None = None):
        if block <= 0:
            raise ValueError(f"block must be positive, got {block}")
        self.block = int(block)
        self.max_tokens = max_tokens
        self._root = _PrefixNode(b"", None, None, 0, None)
        self._tick = 0
        self.cached_tokens = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.checksum_failures = 0

    @property
    def nbytes(self) -> int:
        """Device bytes the interned pages hold."""
        return sum(leaf.numel() * leaf.element_size()
                   for node in self._iter_nodes()
                   for leaf in _leaves(node.pages))

    def _walk_chain(self, tokens: np.ndarray, n_blocks: int):
        """Deepest existing node along ``tokens``'s first ``n_blocks``."""
        node = self._root
        for k in range(n_blocks):
            blk = tokens[k * self.block:(k + 1) * self.block]
            child = node.children.get(_chain_key(node.key, blk))
            if child is None or not np.array_equal(child.tokens, blk):
                break
            node = child
        return node

    def match(self, tokens) -> tuple:
        """Longest interned strict prefix of ``tokens``.

        → ``(n_tokens, node)``: the cached prompt tokens (a multiple of
        ``block``, always < ``len(tokens)``) and the node to clone from,
        or ``(0, None)`` on a miss. Bumps the matched ancestry's recency.
        Every matched node's pages are verified against their intern-time
        checksum: a corrupted node and its subtree are dropped and the
        match truncates to the last clean ancestor. Raises
        :class:`repro_torch.serving.faults.PrefixLookupError` when an
        active fault plan injects an outage on this call.
        """
        tokens = np.asarray(tokens, np.int32)
        if _faults.lookup_fails():
            raise _faults.PrefixLookupError(
                "injected prefix-store lookup failure")
        self._tick += 1
        node = self._walk_chain(tokens, max(0, (len(tokens) - 1)
                                           // self.block))
        node = self._verify_chain(node)
        if node is self._root:
            self.misses += 1
            return 0, None
        n = node
        while n is not self._root:
            n.last_use = self._tick
            n = n.parent
        self.hits += 1
        return node.n_tokens, node

    def _verify_chain(self, node: _PrefixNode) -> _PrefixNode:
        """Checksum the ancestry root→``node`` (one host transfer for the
        chain); at the first mismatch drop that node's subtree and
        truncate the match to its parent."""
        chain = self.chain(node)
        if not chain:
            return node
        same = torch.stack([(_page_checksum(n.pages) == n.checksum).all()
                            for n in chain]).tolist()
        for n, ok in zip(chain, same):
            if not ok:
                self.checksum_failures += 1
                self._drop_subtree(n)
                return n.parent
        return node

    def _drop_subtree(self, node: _PrefixNode) -> None:
        """Remove ``node`` and every descendant from the store."""
        dropped = 1 + sum(1 for _ in self._iter_nodes(node))
        del node.parent.children[node.key]
        node.pages = None
        self.cached_tokens -= dropped * self.block

    def missing(self, tokens) -> bool:
        """True if interning ``tokens`` would create at least one node —
        the cheap pre-check that skips interning an already-cached
        prefix."""
        tokens = np.asarray(tokens, np.int32)
        nb = len(tokens) // self.block
        return self._walk_chain(tokens, nb).n_tokens < nb * self.block

    def insert(self, tokens, cache):
        """Intern the block-aligned prefix of a computed prefill.

        ``tokens`` (a multiple of ``block`` long) must be the first tokens
        the batch-1 ``cache`` (a lane's views are fine: new blocks clone
        their pages out of it) was prefilled with. Existing chain nodes are
        reused. → the chain's deepest node (None when ``tokens`` spans no
        block).
        """
        tokens = np.asarray(tokens, np.int32)
        nb = len(tokens) // self.block
        if nb * self.block != len(tokens):
            raise ValueError("insert() takes a block-aligned prefix")
        node = self._root
        self._tick += 1
        for k in range(nb):
            lo, hi = k * self.block, (k + 1) * self.block
            blk = tokens[lo:hi]
            key = _chain_key(node.key, blk)
            child = node.children.get(key)
            if child is not None:
                if not np.array_equal(child.tokens, blk):
                    break                  # hash collision: stop interning
                child.last_use = self._tick
                node = child
                continue
            pages = _slice_pages(cache, lo, hi)
            child = _PrefixNode(key, node, blk, hi, pages,
                                checksum=_page_checksum(pages))
            # injected post-intern rot: the checksum above was taken on
            # the clean pages, so the next match's verify catches this
            rng = _faults.page_corruption_rng()
            if rng is not None:
                _flip_one_bit(child.pages, rng)
            child.last_use = self._tick
            node.children[key] = child
            self.cached_tokens += self.block
            node = child
        self._evict_cold()
        return None if node is self._root else node

    def chain(self, node: _PrefixNode) -> list:
        """The nodes root→``node``, root first; node ``i`` holds token
        positions ``[i·block, (i+1)·block)``."""
        out = []
        while node is not self._root:
            out.append(node)
            node = node.parent
        out.reverse()
        return out

    def assemble(self, node: _PrefixNode) -> dict:
        """Chain pages root→``node`` concatenated into one batch-1 cache
        (token capacity ``node.n_tokens``)."""
        cache = _concat_pages([n.pages for n in self.chain(node)])
        leaf = cache["layers"]["k"]
        cache["lengths"] = torch.full((1,), node.n_tokens, dtype=torch.int32,
                                      device=leaf.device)
        return cache

    def _iter_nodes(self, node=None):
        node = node if node is not None else self._root
        for child in node.children.values():
            yield child
            yield from self._iter_nodes(child)

    def _evict_cold(self) -> None:
        """Retire cold childless nodes until under the token budget."""
        if self.max_tokens is None:
            return
        while self.cached_tokens > self.max_tokens:
            leaves = [n for n in self._iter_nodes() if not n.refs]
            if not leaves:
                break
            victim = min(leaves, key=lambda n: n.last_use)
            del victim.parent.children[victim.key]
            victim.pages = None
            self.cached_tokens -= self.block
            self.evictions += 1

    def check_invariants(self) -> None:
        """Structural invariants: parent/child links and cumulative token
        counts agree, live nodes hold pages, ``cached_tokens`` is the node
        count × block, and the budget is exceeded only when every node is
        pinned by a child. Raises AssertionError."""
        n_nodes = 0
        for node in self._iter_nodes():
            if node.parent.children.get(node.key) is not node:
                raise AssertionError("prefix node detached from its parent")
            if node.n_tokens != node.parent.n_tokens + self.block:
                raise AssertionError("prefix chain token count is not "
                                     "cumulative")
            if node.pages is None:
                raise AssertionError("live prefix node lost its pages")
            n_nodes += 1
        if self.cached_tokens != n_nodes * self.block:
            raise AssertionError(f"cached_tokens={self.cached_tokens} but "
                                 f"the store holds {n_nodes} blocks of "
                                 f"{self.block}")
        if self.max_tokens is not None \
                and self.cached_tokens > self.max_tokens \
                and not all(n.refs for n in self._iter_nodes()):
            raise AssertionError("store over budget with evictable "
                                 "(childless) nodes")
