"""paddle_tpu_torch.serving.pool against paddle_tpu.serving.pool.

The same call sequences go through both packages' BlockPool and PrefixCache:
the same block ids come out, the refcounts and free counts agree after every
call, chain_keys gives the same hex, and LRU eviction drops the same entries.
"""

import numpy as np
import pytest

from paddle_tpu.serving import pool as jpool
from paddle_tpu_torch.serving import pool as tpool


def _state(pool):
    return ([pool.refcount(b) for b in range(pool.num_blocks)],
            pool.free_blocks, pool.used_blocks)


def test_block_pool_same_ids_and_refcounts():
    pools = [m.BlockPool(10, 16) for m in (jpool, tpool)]
    ops = [("alloc", 3), ("alloc", 2), ("ref", 0), ("free", 1), ("free", 0),
           ("alloc", 1), ("ref", 4), ("free", 4), ("free", 4), ("alloc", 4),
           ("free", 2)]
    got = [[], []]
    for pool, out in zip(pools, got):
        held = []
        for op, arg in ops:
            if op == "alloc":
                ids = pool.alloc(arg)
                held += ids
                out.append(("alloc", ids))
            elif op == "ref":
                out.append(("ref", pool.ref(held[arg])))
            else:
                out.append(("free", pool.free(held[arg])))
            out.append(_state(pool))
    assert got[0] == got[1]
    assert tpool.SCRATCH_BLOCK == jpool.SCRATCH_BLOCK == 0


@pytest.mark.parametrize("mod", [jpool, tpool], ids=["jax", "torch"])
def test_block_pool_refusals(mod):
    p = mod.BlockPool(4, 8)
    with pytest.raises(mod.PoolExhausted):
        p.alloc(4)
    a = p.alloc(1)[0]
    p.free(a)
    with pytest.raises(ValueError):
        p.free(a)                        # double free
    for bad in (lambda: p.ref(0), lambda: p.free(0)):
        with pytest.raises(ValueError):
            bad()                        # scratch is never shared or freed
    with pytest.raises(ValueError):
        mod.BlockPool(1, 8)
    with pytest.raises(ValueError):
        mod.BlockPool(4, 12)


def test_chain_keys_same_hex():
    toks = np.random.RandomState(0).randint(0, 32000, 300)
    for bt in (16, 128):
        assert tpool.chain_keys(toks, bt) == jpool.chain_keys(toks, bt)
    assert len(tpool.chain_keys(toks, 128)) == 2


def _drive_cache(mod):
    """Insert, look up, evict and clear; record what both sides see."""
    pool = mod.BlockPool(20, 8)
    cache = mod.PrefixCache(pool, capacity_blocks=4)
    r = np.random.RandomState(1)
    sys_p = r.randint(3, 500, 24)                 # 3 full blocks
    a = np.concatenate([sys_p, r.randint(3, 500, 5)])
    b = np.concatenate([sys_p, r.randint(3, 500, 17)])
    c = r.randint(3, 500, 17)
    log = []
    bids_a = pool.alloc(3)
    log.append(("insert a", cache.insert(a, 0, block_ids=bids_a)))
    hits = cache.lookup(b, (len(b) - 1) // 8, record=False)
    log.append(("probe b", [e.block_id for e in hits], cache.hit_blocks))
    cache.commit(hits, (len(b) - 1) // 8)
    for e in hits:
        pool.ref(e.block_id)
    bids_b = [e.block_id for e in hits] + pool.alloc(2)
    log.append(("insert b", cache.insert(b, len(hits),
                                         block_ids=bids_b[len(hits):5])))
    log.append(("len", len(cache), _state(pool)))
    bids_c = pool.alloc(2)
    # capacity 4: inserting c's 2 blocks evicts the 2 least recently used
    log.append(("insert c", cache.insert(c, 0, block_ids=bids_c)))
    log.append(("after evict", len(cache), _state(pool),
                [e.depth for e in cache.lookup(a)],
                [e.block_id for e in cache.lookup(c)]))
    for bid in bids_a + bids_b + bids_c:
        pool.free(bid)                           # the requests retire
    log.append(("evictable", cache.evictable_count()))
    log.append(("evict_free", cache.evict_free(1), _state(pool)))
    log.append(("hit rate", cache.hit_rate, cache.hit_blocks,
                cache.lookup_blocks))
    cache.clear()
    log.append(("clear", len(cache), _state(pool)))
    return log


def test_prefix_cache_same_sequence():
    assert _drive_cache(tpool) == _drive_cache(jpool)
    log = dict((e[0], e[1:]) for e in _drive_cache(tpool))
    assert log["clear"][1][2] == 0                # no block leaks


@pytest.mark.parametrize("mod", [jpool, tpool], ids=["jax", "torch"])
def test_prefix_cache_lookup_cap_and_keep(mod):
    pool = mod.BlockPool(10, 8)
    cache = mod.PrefixCache(pool, capacity_blocks=8)
    p = np.arange(40)                            # 5 full blocks
    bids = pool.alloc(5)
    assert cache.insert(p, 0, block_ids=bids) == 5
    assert [e.depth for e in cache.lookup(p, max_blocks=2)] == [0, 1]
    hits = cache.lookup(p)
    for bid in bids:
        pool.free(bid)
    # a shared block (refcount 2) is pinned; keep entries are never evicted
    pool.ref(bids[4])
    assert cache.evict_free(5, keep=hits[:1]) == 3
    assert [e.block_id for e in cache.lookup(p)] == [bids[0]]
    assert pool.refcount(bids[4]) == 2 and len(cache) == 2
