"""Host-side bookkeeping for the paged KV-cache: block pool + prefix cache.

This module is deliberately device-free (plain Python, no jax): it decides
*which* pool blocks hold *whose* tokens; ``repro_torch.serve.paged`` owns the
device arrays and moves data. Splitting the two keeps the allocator unit-
testable and the jitted programs shape-stable.

Design (vLLM-style):

  * Block 0 is the reserved **null block**: padded block-table entries point
    at it, padded scatters write into it, and it is never allocated. That
    keeps every gather/scatter a fixed-shape fancy-index with no masks on the
    device side.
  * Every allocated block carries a **refcount** (number of requests mapping
    it). Full blocks whose content is immutable can additionally be
    **registered** under a token-hash chain; a registered block whose
    refcount drops to zero is not freed but parked in an LRU of evictable
    blocks — a later request with the same prefix re-hits it for free, and
    pool pressure reclaims it oldest-first (``alloc`` evicts transparently).
  * **Copy-on-write**: appending to a block another request can still see
    (ref > 1, or parked in the prefix cache) must first split it. ``cow``
    hands back a private block id and tells the caller to copy the device
    data.
  * The **prefix cache** keys full blocks by a hash *chain*
    (``h_j = H(h_{j-1}, tokens_j)``) so a hit certifies the entire prefix,
    and every lookup re-checks token identity — a hash collision degrades to
    a miss, never to cross-request token leakage.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

NULL_BLOCK = 0


@dataclasses.dataclass
class BlockMeta:
    """Lifetime bookkeeping for one pool block."""

    bid: int
    ref: int = 0
    # set once the block is full and registered in the prefix cache
    chain_hash: Optional[int] = None
    # generation stamps for read-time verification amortization: ``gen``
    # moves on every engine write to the block's device data (scatter,
    # append, COW copy, repair); ``verified_gen`` records the generation the
    # block's checksums last verified clean at read time. A block whose
    # stamps match was proven intact and untouched since — the stamped
    # policy skips re-folding it.
    gen: int = 0
    verified_gen: int = -1
    # monotone pool-wide clock value of the last read-time verification —
    # the background scrub pass re-folds oldest-verified-first so the
    # stamped policy's deferred-detection window stays bounded
    verified_at: int = -1


@dataclasses.dataclass
class PoolStats:
    allocs: int = 0
    evictions: int = 0
    cow_copies: int = 0


class BlockPool:
    """Refcounted fixed-size block allocator with LRU reuse of cached blocks.

    ``on_evict(bid, chain_hash)`` is called when pool pressure reclaims a
    parked prefix-cache block, so the :class:`PrefixCache` can forget its
    mapping. The pool never touches device memory.
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 1:
            raise ValueError("need at least one allocatable block")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # ids 1..num_blocks; 0 is the null block
        self._free: collections.deque = collections.deque(
            range(1, num_blocks + 1))
        self._meta: Dict[int, BlockMeta] = {}
        # parked prefix-cache blocks (ref == 0, registered), LRU order
        self._evictable: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()
        self.on_evict = lambda bid, chain_hash: None
        self.stats = PoolStats()
        self._verify_clock = 0

    # -- capacity -----------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        """Blocks allocatable right now (free list + evictable cache)."""
        return len(self._free) + len(self._evictable)

    @property
    def live_blocks(self) -> int:
        return len(self._meta)

    def ref_of(self, bid: int) -> int:
        return self._meta[bid].ref if bid in self._meta else 0

    def is_shared(self, bid: int) -> bool:
        """True when another holder (a request or the prefix cache) can still
        observe this block — appending to it requires copy-on-write."""
        m = self._meta.get(bid)
        return m is not None and (m.ref > 1 or m.chain_hash is not None)

    # -- alloc / free -------------------------------------------------------
    def alloc(self) -> Optional[int]:
        """Allocate a block (ref = 1), evicting the LRU parked prefix-cache
        block under pressure. None when truly out of blocks."""
        if self._free:
            bid = self._free.popleft()
        elif self._evictable:
            bid, _ = self._evictable.popitem(last=False)
            meta = self._meta.pop(bid)
            self.stats.evictions += 1
            self.on_evict(bid, meta.chain_hash)
        else:
            return None
        self._meta[bid] = BlockMeta(bid=bid, ref=1)
        self.stats.allocs += 1
        return bid

    def ref_inc(self, bid: int) -> None:
        meta = self._meta[bid]
        if meta.ref == 0:       # re-hit of a parked cached block
            self._evictable.pop(bid, None)
        meta.ref += 1

    def ref_dec(self, bid: int) -> None:
        meta = self._meta.get(bid)
        if meta is None or meta.ref <= 0:
            raise ValueError(f"block {bid} double-freed")
        meta.ref -= 1
        if meta.ref > 0:
            return
        if meta.chain_hash is not None:
            # keep content for future prefix hits; reclaimable LRU-first
            self._evictable[bid] = None
        else:
            del self._meta[bid]
            self._free.append(bid)

    # -- generation stamps (read-time verification amortization) ------------
    def note_write(self, bid: int) -> None:
        """Record that the engine rewrote this block's device data (and
        refreshed its checksums): any read-time verification stamp is now
        stale. Unknown/null ids are ignored."""
        m = self._meta.get(bid)
        if m is not None:
            m.gen += 1

    def mark_verified(self, bid: int) -> None:
        """Stamp the block as read-time verified at its current generation
        (call only after a decode attempt that folded it committed clean)."""
        m = self._meta.get(bid)
        if m is not None:
            m.verified_gen = m.gen
            m.verified_at = self._verify_clock
            self._verify_clock += 1

    def needs_verify(self, bid: int) -> bool:
        """True unless the block verified clean at its current generation.
        Freshly (re)allocated blocks always need a first verification."""
        m = self._meta.get(bid)
        return m is None or m.verified_gen != m.gen

    def verified_at(self, bid: int) -> int:
        """Verification recency (monotone clock; -1 = never verified).
        The scrub pass re-folds the lowest values first."""
        m = self._meta.get(bid)
        return -1 if m is None else m.verified_at

    # -- parked prefix-cache blocks (background scrub coverage) --------------
    def parked_blocks(self) -> List[int]:
        """Blocks parked in the prefix cache (ref == 0, content retained for
        future hits). They appear in no live block table, so the read-time
        verification never touches them — the background scrub draws from
        this list after the live tables so a bit flip that lands while a
        shared prefix is parked is caught *before* the next admission
        gathers it."""
        return list(self._evictable)

    def discard_parked(self, bid: int) -> None:
        """Drop a parked block whose content failed verification: forget its
        prefix-cache registration (``on_evict``) and return it to the free
        list. Detection-before-use repair for cache-only state — the next
        admission simply misses and re-prefills fresh blocks."""
        if bid not in self._evictable:
            raise ValueError(f"block {bid} is not parked")
        del self._evictable[bid]
        meta = self._meta.pop(bid)
        self._free.append(bid)
        self.on_evict(bid, meta.chain_hash)

    # -- sharing ------------------------------------------------------------
    def register(self, bid: int, chain_hash: int) -> None:
        """Mark a (full, immutable) block as prefix-cache content."""
        self._meta[bid].chain_hash = chain_hash

    def touch(self, bid: int) -> None:
        """Refresh LRU recency of a parked block (on prefix-cache hit)."""
        if bid in self._evictable:
            self._evictable.move_to_end(bid)

    def cow(self, bid: int) -> Tuple[Optional[int], bool]:
        """Prepare ``bid`` for an append. Returns ``(write_bid, needs_copy)``:
        the id to write through, and whether the caller must copy the device
        block (old -> new) first. Drops this holder's ref on the shared
        original. None when the pool cannot supply the private copy."""
        if not self.is_shared(bid):
            return bid, False
        new = self.alloc()
        if new is None:
            return None, False
        self.ref_dec(bid)
        self.stats.cow_copies += 1
        return new, True


def chain_hash(parent: Optional[int], tokens: Tuple[int, ...]) -> int:
    """Position-chained content hash of one full block of tokens."""
    return hash((parent, tokens))


@dataclasses.dataclass
class PrefixStats:
    lookups: int = 0
    hit_tokens: int = 0
    lookup_tokens: int = 0
    collisions: int = 0


@dataclasses.dataclass
class _CacheEntry:
    bid: int
    parent: Optional[int]
    tokens: Tuple[int, ...]


class PrefixCache:
    """Token-hash-chain map from full prompt blocks to resident pool blocks.

    ``match`` walks the chain of *full* blocks of a token sequence and
    returns the longest resident run; every step re-verifies the stored
    tokens (and parent link) so a Python-hash collision is a recorded miss,
    never a silent wrong-prefix hit.
    """

    def __init__(self, pool: BlockPool):
        self.pool = pool
        self._by_hash: Dict[int, _CacheEntry] = {}
        self.stats = PrefixStats()
        pool.on_evict = self._forget

    def _forget(self, bid: int, h: Optional[int]) -> None:
        if h is not None and self._by_hash.get(h, None) is not None \
                and self._by_hash[h].bid == bid:
            del self._by_hash[h]

    def match(self, tokens: Sequence[int],
              max_blocks: Optional[int] = None) -> List[int]:
        """Longest chain of resident full blocks covering a prefix of
        ``tokens``. Returns their block ids (refcounts NOT taken — the
        caller claims them with ``pool.ref_inc`` while it still holds the
        admission lock, i.e. synchronously)."""
        bs = self.pool.block_size
        n_full = len(tokens) // bs
        if max_blocks is not None:
            n_full = min(n_full, max_blocks)
        self.stats.lookups += 1
        self.stats.lookup_tokens += len(tokens)
        hits: List[int] = []
        parent: Optional[int] = None
        for j in range(n_full):
            blk = tuple(int(t) for t in tokens[j * bs:(j + 1) * bs])
            h = chain_hash(parent, blk)
            e = self._by_hash.get(h)
            if e is None:
                break
            if e.tokens != blk or e.parent != parent:
                self.stats.collisions += 1
                break
            hits.append(e.bid)
            self.pool.touch(e.bid)
            parent = h
        self.stats.hit_tokens += len(hits) * bs
        return hits

    def insert(self, tokens: Sequence[int], bids: Sequence[int]) -> None:
        """Register every full block of ``tokens`` (held in ``bids``) for
        future sharing. Already-registered chain links are left in place."""
        bs = self.pool.block_size
        parent: Optional[int] = None
        for j in range(len(tokens) // bs):
            if j >= len(bids):
                break
            blk = tuple(int(t) for t in tokens[j * bs:(j + 1) * bs])
            h = chain_hash(parent, blk)
            e = self._by_hash.get(h)
            if e is None or e.tokens != blk or e.parent != parent:
                if e is not None:
                    self.stats.collisions += 1
                self._by_hash[h] = _CacheEntry(bid=int(bids[j]),
                                               parent=parent, tokens=blk)
                self.pool.register(int(bids[j]), h)
            parent = h

    @property
    def cached_blocks(self) -> int:
        return len(self._by_hash)
