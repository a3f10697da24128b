"""Slot-based ring KV-cache pool for continuous batching.

The pool holds a fixed number of request *slots*, each a full per-layer
ring KV cache (the ring semantics — ``slot = position % cache_len`` plus
``kv_positions`` mask reconstruction — live in
``repro_torch.models.attention``; this module only manages slot lifetime).

Device layout: the model's stacked :class:`KVCache` with the batch axis as
the slot axis, ``k``/``v`` (num_layers, n_slots, Hkv, cache_len, hd), and
one position counter per slot, ``pos`` (n_slots,), so every slot advances
independently. (The JAX package widens its per-layer counter to
(num_layers, n_slots) and vmaps the decode step over the slot axis; the
port's decode is batched over slots directly.)

Slot bookkeeping (the free list) is host-side: admissions and evictions
happen between steps, never inside them.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.models.attention import KVCache


class KVCachePool:
    """Fixed-capacity pool of per-request ring KV caches.

    ``state`` is the live device cache; ``alloc``/``release`` manage the
    host-side free list; ``write_row`` installs a freshly prefilled batch-1
    cache into a slot and pins that slot's position to the request's true
    prompt length (invalidating any padded prefill slots).
    """

    def __init__(self, model, n_slots: int, cache_len: int):
        if n_slots < 1:
            raise ValueError("need at least one slot")
        self.n_slots = n_slots
        self.cache_len = cache_len
        self.state: KVCache = model.init_cache(n_slots, cache_len=cache_len)
        self._free: List[int] = list(range(n_slots))

    # -- host-side slot lifetime -------------------------------------------
    @property
    def free_slots(self) -> int:
        return len(self._free)

    def alloc(self) -> Optional[int]:
        return self._free.pop(0) if self._free else None

    def release(self, slot: int) -> None:
        if slot in self._free:
            raise ValueError(f"slot {slot} double-freed")
        self._free.append(slot)
        self._free.sort()

    # -- device-side row plumbing ------------------------------------------
    def write_row(self, slot: int, row_cache: KVCache, length: int) -> None:
        """Install a batch-1 prefilled cache into ``slot`` (the whole ring,
        in place) with its position counter rewound to ``length`` (the
        true, unpadded prompt length)."""
        self.state.k[:, slot] = row_cache.k[:, 0]
        self.state.v[:, slot] = row_cache.v[:, 0]
        self.state.pos[slot] = int(length)
