"""Paged KV-cache pool: block allocator + content-hashed prefix cache.

Port of ``paddle_tpu/serving/pool.py`` (plain Python, numpy and hashlib —
copied, not imported). The serving engine draws fixed-size KV *blocks*
from one shared pool and maps each slot's logical cache through a per-slot
block table; this module is the host-side bookkeeping for that pool.

``BlockPool`` is a refcounted free-list allocator over physical block
ids. Block 0 is reserved as the *scratch* block: inactive batch rows and
the unallocated tail of every block table point at it, so the kernel's
table-resolved loads always address a valid block.

``PrefixCache`` content-hashes block-aligned prompt prefixes (a chain
hash, so a block's identity includes everything before it). Full prompt
blocks are shared copy-on-write across requests: decode only ever
*appends*, and only the partially-filled tail block of a prompt can
receive appends, so full blocks are immutable and sharing them never needs
a copy. Over a bf16 pool the cache shares physical blocks (refcounted);
over an int8 pool, whose blocks carry each slot's own scales, an entry
holds the block's exact bf16 KV on the host (``PrefixEntry.kv_host``) and
no pool reference, and a hit requantizes it.

Not ported yet (ROADMAP Queue A item 7): ``HostBlockStore`` (offload) and
``TierPrefixStore`` (router).
"""

import hashlib
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["BlockPool", "PoolExhausted", "PrefixCache", "PrefixEntry",
           "SCRATCH_BLOCK", "chain_keys"]

# physical block id 0: never allocated, target of every masked table entry
SCRATCH_BLOCK = 0


class PoolExhausted(RuntimeError):
    """The pool has fewer free blocks than an allocation needs."""


class BlockPool:
    """Refcounted allocator over ``num_blocks`` physical KV blocks.

    Invariants (pinned by tests/test_torch_serving_pool.py):

    * block 0 (``SCRATCH_BLOCK``) is never handed out and never freed;
    * a block is on the free list iff its refcount is 0;
    * ``free()`` below refcount 0 raises — a double-free would let two
      slots write the same physical block.
    """

    def __init__(self, num_blocks: int, block_tokens: int):
        if num_blocks < 2:
            raise ValueError(
                f"need >= 2 blocks (1 scratch + 1 usable), got {num_blocks}")
        if block_tokens % 8:
            raise ValueError(
                f"block_tokens must be a multiple of 8, got {block_tokens}")
        self.num_blocks = int(num_blocks)
        self.block_tokens = int(block_tokens)
        # LIFO free list: a just-freed block is re-issued first, so a hot
        # pool cycles a small working set of physical blocks
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._refs = [0] * num_blocks

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - 1 - len(self._free)

    def refcount(self, bid: int) -> int:
        return self._refs[bid]

    def alloc(self, n: int = 1) -> List[int]:
        """Take ``n`` blocks (refcount 1 each). Raises PoolExhausted —
        admission control is the caller's job; this is the backstop."""
        if n > len(self._free):
            raise PoolExhausted(
                f"need {n} KV blocks, pool has {len(self._free)} free "
                f"of {self.num_blocks - 1}")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._refs[b] = 1
        return out

    def ref(self, bid: int) -> int:
        """Add a reference to an allocated block (prefix sharing)."""
        if bid == SCRATCH_BLOCK:
            raise ValueError("the scratch block cannot be shared")
        if self._refs[bid] <= 0:
            raise ValueError(f"block {bid} is not allocated")
        self._refs[bid] += 1
        return self._refs[bid]

    def free(self, bid: int) -> bool:
        """Drop one reference; returns True when the block went back to
        the free list (refcount hit 0)."""
        if bid == SCRATCH_BLOCK:
            raise ValueError("the scratch block cannot be freed")
        if self._refs[bid] <= 0:
            raise ValueError(f"double free of block {bid}")
        self._refs[bid] -= 1
        if self._refs[bid] == 0:
            self._free.append(bid)
            return True
        return False


def _chain_hash(parent: bytes, tokens: np.ndarray) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    h.update(parent)
    h.update(np.ascontiguousarray(tokens, dtype=np.int64).tobytes())
    return h.digest()


def chain_keys(tokens: Sequence[int], block_tokens: int) -> List[str]:
    """Hex chain keys of every FULL block of ``tokens`` — the same hash
    walk :class:`PrefixCache` uses."""
    tokens = np.asarray(tokens)
    out, parent = [], b""
    for c in range(len(tokens) // block_tokens):
        parent = _chain_hash(
            parent, tokens[c * block_tokens:(c + 1) * block_tokens])
        out.append(parent.hex())
    return out


class PrefixEntry:
    """One cached full prompt block. ``block_id`` — bf16 pools: the shared
    physical block (the cache holds its own pool reference). ``kv_host`` —
    int8 pools: the exact bf16 KV (L, block_tokens, 2*nkv*hd) kept on the
    host, requantized with each adopting request's own scales."""

    __slots__ = ("key", "depth", "block_id", "kv_host", "tick")

    def __init__(self, key: bytes, depth: int,
                 block_id: Optional[int] = None, kv_host=None):
        self.key = key
        self.depth = depth          # chain position (0 = first block)
        self.block_id = block_id
        self.kv_host = kv_host
        self.tick = 0


class PrefixCache:
    """Chain-hashed prompt-prefix cache over a :class:`BlockPool`.

    ``lookup`` walks the longest cached chain of *full* blocks for a
    prompt; ``insert`` registers a freshly prefilled prompt's full
    blocks. Capacity is counted in blocks; eviction is LRU. Evicting a
    mid-chain entry merely shortens future lookups (lookup stops at the
    first missing link).
    """

    def __init__(self, pool: BlockPool, capacity_blocks: int = 256):
        self.pool = pool
        self.capacity = int(capacity_blocks)
        self._entries: Dict[bytes, PrefixEntry] = {}
        self._tick = 0
        self.hit_blocks = 0
        self.lookup_blocks = 0

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, prompt: Sequence[int],
               max_blocks: Optional[int] = None,
               record: bool = True) -> List[PrefixEntry]:
        """Longest cached chain of full blocks covering ``prompt``.

        ``max_blocks`` caps the walk — the engine passes
        ``(len(prompt) - 1) // block_tokens`` so at least one prompt
        token is always left to prefill (its logits seed sampling).
        ``record=False`` probes without touching the hit/lookup counters
        or LRU ticks; :meth:`commit` accounts the probe once the request
        is admitted.
        """
        bt = self.pool.block_tokens
        prompt = np.asarray(prompt)
        n_full = len(prompt) // bt
        if max_blocks is not None:
            n_full = min(n_full, max_blocks)
        out: List[PrefixEntry] = []
        parent = b""
        for c in range(n_full):
            key = _chain_hash(parent, prompt[c * bt:(c + 1) * bt])
            e = self._entries.get(key)
            if e is None:
                break
            out.append(e)
            parent = key
        if record:
            self.commit(out, n_full)
        return out

    def commit(self, hits: Sequence[PrefixEntry], n_lookup: int):
        """Account a ``record=False`` probe: bump hit/lookup counters
        and refresh the hit entries' LRU ticks."""
        self.lookup_blocks += n_lookup
        self.hit_blocks += len(hits)
        for e in hits:
            self._tick += 1
            e.tick = self._tick

    def insert(self, prompt: Sequence[int], n_reused: int,
               block_ids: Optional[Sequence[int]] = None,
               kv_host: Optional[Sequence] = None) -> int:
        """Register the full blocks of a just-prefilled prompt.

        ``n_reused`` leading blocks came from this cache (already
        present). For each NEW full block ``c`` give either its physical
        ``block_ids[c - n_reused]`` (bf16 pool: the cache takes its own
        pool reference, so the block outlives the producing request) or
        its host copy ``kv_host[c - n_reused]`` (int8 pool: no pool
        reference). Returns the number of entries added.
        """
        bt = self.pool.block_tokens
        prompt = np.asarray(prompt)
        n_full = len(prompt) // bt
        parent = b""
        added = 0
        for c in range(n_full):
            key = _chain_hash(parent, prompt[c * bt:(c + 1) * bt])
            if c >= n_reused and key not in self._entries:
                i = c - n_reused
                bid = block_ids[i] if block_ids is not None else None
                kv = kv_host[i] if kv_host is not None else None
                if bid is None and kv is None:
                    break       # the caller ran out of payload
                if bid is not None:
                    self.pool.ref(bid)
                e = PrefixEntry(key, c, block_id=bid, kv_host=kv)
                self._tick += 1
                e.tick = self._tick
                self._entries[key] = e
                added += 1
            parent = key
        self._evict()
        return added

    def _evict(self):
        while len(self._entries) > self.capacity:
            key = min(self._entries, key=lambda k: self._entries[k].tick)
            e = self._entries.pop(key)
            if e.block_id is not None:
                self.pool.free(e.block_id)

    def evictable_count(self, keep: Sequence = ()) -> int:
        """How many physical blocks :meth:`evict_free` could reclaim
        right now (cache-only references, not in ``keep``)."""
        skip = {id(e) for e in keep}
        return sum(1 for e in self._entries.values()
                   if e.block_id is not None and id(e) not in skip
                   and self.pool.refcount(e.block_id) == 1)

    def evict_free(self, n_blocks: int, keep: Sequence = ()) -> int:
        """Return up to ``n_blocks`` physical blocks to the pool by
        evicting LRU entries the cache ALONE still references (refcount
        1 — a block a live slot shares is pinned by that slot's ref).
        ``keep`` entries (this admission's own hits) are never evicted.
        Returns the number of blocks actually freed."""
        skip = {id(e) for e in keep}
        freed = 0
        for key in sorted(self._entries,
                          key=lambda k: self._entries[k].tick):
            if freed >= n_blocks:
                break
            e = self._entries[key]
            if id(e) in skip or e.block_id is None:
                continue
            if self.pool.refcount(e.block_id) == 1:
                self.pool.free(e.block_id)
                del self._entries[key]
                freed += 1
        return freed

    def clear(self):
        for e in self._entries.values():
            if e.block_id is not None:
                self.pool.free(e.block_id)
        self._entries.clear()

    @property
    def hit_rate(self) -> float:
        return self.hit_blocks / self.lookup_blocks if self.lookup_blocks \
            else 0.0
