"""Paged-KV bookkeeping for the continuous batcher.

The paper's thesis is that skipping work only pays when the surrounding
machinery is reorganized around the skip; for serving, the cache layer is
that machinery. A contiguous per-slot reservation of ``max_len`` rows
gives back the HBM a freed slot saved, so the pool here mirrors SCNN's
compressed storage of sparse state: fixed-size KV blocks shared by every
slot, handed out lazily as sequences grow and returned to the free list
the moment a request releases.

Everything in this module is HOST-side and pure numpy/python: the device
only ever sees a pool of blocks plus an int32 block table passed into the
decode step. Block 0 of every pool is reserved as the NULL block:
freed slots' table rows point at it, so their (masked, discarded) decode
writes land somewhere harmless and can never corrupt a live neighbour.

SPMD serving: on a (data, model) mesh the server shards the pool over
'data' and keeps ONE allocator + prefix index PER DATA SHARD, each
accounting in per-shard block units (its sub-pool's usable blocks, its
own null block 0 at local id 0) -- the paper's per-core SASA, one skip
table per core. Allocator/index ids are shard-LOCAL; only the engine's
GSPMD pool scatter/gather ops see global flat ids (local + owner base).
Nothing in this module knows about meshes, which is the point: the same
ledger serves any shard count.

Blocks are REFCOUNTED so the prefix cache can share them across slots:
``alloc`` hands a block out at refcount 1, :meth:`retain` adds a holder
(a new slot mapping a cached prefix block read-only, or the prefix index
itself), and :meth:`release` drops one -- the block returns to the free
list only when its last holder lets go. :meth:`free` is the historical
single-holder spelling and simply releases. Copy-on-write is
:meth:`fork`: take a fresh block (the device-side row copy is the
caller's job) and drop the caller's reference on the shared original in
one atomic step, so the ledger never transiently over- or under-counts.

Thread-safety: :class:`BlockAllocator` serializes every operation --
including the check-then-reserve of :meth:`try_reserve` -- on one
internal lock, so an admission running on the engine thread can never
race a concurrent :meth:`~repro_torch.runtime.server.AsyncServer.submit` (or a
second engine) into promising the same blocks twice. The commitment
invariant ``reserved + in_use <= num_blocks`` and the free/allocated
partition are enforced on every mutation (:meth:`check`), and releasing
a commitment below zero -- the double-count a released slot would cause
-- raises instead of silently corrupting admission accounting.

:class:`PrefixCache` is the prefix index on top: token-id chunks of one
block are chain-hashed (hash of block i covers blocks 0..i), so a lookup
walks the chain until the first miss and returns the longest cached
prefix as ready-to-map pool block ids. The cache holds one reference per
registered block; eviction (LRU, under admission pressure) only touches
blocks no live slot shares.
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict, deque
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

NULL_BLOCK = 0


class BlockAllocator:
    """Free-list allocator over pool block ids ``1..num_blocks`` (0 = null),
    with atomic worst-case COMMITMENT accounting for admission control.

    Two kinds of bookkeeping live here:

      * **allocation** -- blocks physically handed out (``in_use``);
      * **reservation** -- blocks PROMISED to admitted requests but not
        yet allocated (``reserved``). Admission reserves a request's
        worst case up front (:meth:`try_reserve`), lazy growth draws the
        promise down (``alloc(..., reserved=True)``), and release returns
        the unused remainder (:meth:`unreserve`). Deadlock-freedom of
        lazy growth depends on ``available - reserved`` never going
        negative, which ``try_reserve`` checks and updates under ONE
        lock -- the check-then-act is atomic even with concurrent
        callers.

    Invariants (enforced, and property-tested in tests/test_paged_kv.py,
    tests/test_prefix_cache.py and tests/test_scheduler.py):
      * a block is never handed out twice without an intervening free;
      * releasing/freeing a block that is not allocated raises;
      * ``available + in_use == num_blocks`` at all times;
      * every allocated block has refcount >= 1, and a block only
        returns to the free list when its refcount reaches 0;
      * ``0 <= reserved <= available`` at all times -- in particular,
        un-reserving more than is outstanding (a released slot counted
        twice) raises rather than freeing phantom capacity.
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 1:
            raise ValueError("pool needs at least one usable block")
        self.num_blocks = num_blocks
        self._lock = threading.RLock()
        self._free: deque[int] = deque(range(1, num_blocks + 1))
        self._allocated: set[int] = set()
        self._refcount: Dict[int, int] = {}
        self._reserved = 0

    @property
    def available(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def in_use(self) -> int:
        with self._lock:
            return len(self._allocated)

    @property
    def reserved(self) -> int:
        """Blocks promised to admitted requests but not yet allocated."""
        with self._lock:
            return self._reserved

    def can_reserve(self, n: int) -> bool:
        """Advisory fit check; only :meth:`try_reserve` is authoritative."""
        with self._lock:
            return n <= len(self._free) - self._reserved

    def try_reserve(self, n: int) -> bool:
        """Atomically promise ``n`` blocks if uncommitted capacity covers
        them. This is THE admission gate: check and update happen under
        the lock, so two admitters can never both see the same headroom."""
        if n < 0:
            raise ValueError(f"cannot reserve {n} blocks")
        with self._lock:
            if n > len(self._free) - self._reserved:
                return False
            self._reserved += n
            return True

    def unreserve(self, n: int) -> None:
        """Return an unused commitment (release path, or admission abort).

        Raises if it would push the outstanding reservation negative --
        the signature of a released slot's commitment being counted
        twice, which would let admission overpromise the pool.
        """
        with self._lock:
            if n < 0 or n > self._reserved:
                raise RuntimeError(
                    f"commitment double-count: unreserve({n}) with only "
                    f"{self._reserved} blocks outstanding"
                )
            self._reserved -= n

    def alloc(self, n: int, *, reserved: bool = False) -> List[int]:
        """Pop ``n`` blocks; raises if the free list cannot cover them.

        ``reserved=True`` draws the blocks out of this caller's prior
        :meth:`try_reserve` promise (lazy growth / admission's initial
        prompt blocks). ``reserved=False`` is an unpromised allocation
        and may not eat into capacity promised to others.
        """
        with self._lock:
            if n < 0:
                raise ValueError(f"cannot allocate {n} blocks")
            if reserved and n > self._reserved:
                raise RuntimeError(
                    f"allocating {n} committed blocks but only "
                    f"{self._reserved} are reserved"
                )
            headroom = len(self._free) if reserved else (
                len(self._free) - self._reserved)
            if n > headroom:
                raise RuntimeError(
                    f"KV pool exhausted: need {n} blocks, "
                    f"{len(self._free)} free ({self._reserved} reserved)"
                )
            out = [self._free.popleft() for _ in range(n)]
            self._allocated.update(out)
            for b in out:
                self._refcount[b] = 1
            if reserved:
                self._reserved -= n
            return out

    def refcount(self, block: int) -> int:
        """Current holder count of ``block`` (0 if not allocated)."""
        with self._lock:
            return self._refcount.get(block, 0)

    def retain(self, blocks: Iterable[int]) -> None:
        """Add one holder to each block (prefix sharing: a new slot maps
        a cached block read-only, or the prefix index publishes it).
        Retaining a block that is not allocated raises -- a stale table
        entry must never resurrect a freed block."""
        with self._lock:
            blocks = list(blocks)
            for b in blocks:
                if b not in self._allocated:
                    raise RuntimeError(
                        f"retain of unallocated KV block {b}"
                    )
            for b in blocks:
                self._refcount[b] += 1

    def release(self, blocks: Iterable[int]) -> None:
        """Drop one holder per block; a block whose last holder lets go
        returns to the free list. Releasing an unallocated block (or
        more times than it was retained) raises -- the double-free
        invariant, refcount-generalized."""
        with self._lock:
            for b in blocks:
                if b not in self._allocated:
                    raise RuntimeError(
                        f"double-free / foreign free of KV block {b}"
                    )
                self._refcount[b] -= 1
                if self._refcount[b] == 0:
                    del self._refcount[b]
                    self._allocated.remove(b)
                    self._free.append(b)

    # Historical single-holder spelling; every pre-refcount call site
    # (one ref per block by construction) keeps its exact semantics.
    free = release

    def fork(self, block: int, *, reserved: bool = False) -> int:
        """Copy-on-write bookkeeping: allocate a fresh block to replace
        shared ``block`` and drop the caller's reference on the original,
        atomically. The original stays alive for its other holders; the
        new block starts at refcount 1. The device-side row copy is the
        caller's job (``model.copy_pool_block``)."""
        with self._lock:
            (new,) = self.alloc(1, reserved=reserved)
            try:
                self.release([block])
            except RuntimeError:
                # Roll the fresh block back so a bogus fork cannot leak.
                self.release([new])
                raise
            return new

    def check(self, expect_reserved: Optional[int] = None) -> None:
        """Structural invariant: free + allocated partition the pool, and
        reservations fit inside the free portion. ``expect_reserved``
        lets the engine cross-check its per-slot commitment ledger (sum
        of ``commit - len(blocks)`` over live slots) against the
        allocator's counter -- a mismatch means a release was double
        counted or leaked."""
        with self._lock:
            free = set(self._free)
            if len(free) != len(self._free):
                raise AssertionError("duplicate block on the free list")
            if free & self._allocated:
                raise AssertionError("block both free and allocated")
            if len(free) + len(self._allocated) != self.num_blocks:
                raise AssertionError("pool leaked or grew blocks")
            if NULL_BLOCK in free or NULL_BLOCK in self._allocated:
                raise AssertionError("null block entered circulation")
            if set(self._refcount) != self._allocated:
                raise AssertionError(
                    "refcount ledger out of sync with the allocated set"
                )
            if any(c < 1 for c in self._refcount.values()):
                raise AssertionError("allocated block with refcount < 1")
            if not (0 <= self._reserved <= len(self._free)):
                raise AssertionError(
                    f"reservation accounting broken: {self._reserved} "
                    f"promised, {len(self._free)} free"
                )
            if (expect_reserved is not None
                    and expect_reserved != self._reserved):
                raise AssertionError(
                    f"commitment ledger mismatch: engine expects "
                    f"{expect_reserved} outstanding, allocator holds "
                    f"{self._reserved}"
                )


class PrefixCache:
    """Block-granular prefix index over the paged KV pool.

    Keys are CHAIN hashes of whole token-id chunks of ``block_size``:
    the key of block i digests (key of block i-1, tokens of chunk i), so
    equal keys imply equal full prefixes, not just equal chunks, and a
    lookup can walk keys left to right stopping at the first miss. Only
    FULL prompt blocks are ever registered -- a partially written block
    (prompt tail, decode appends) never enters the index, which is what
    keeps shared blocks read-only for their whole lifetime.

    Reference discipline: the index holds ONE allocator reference per
    registered block; :meth:`lookup` retains each matched block on
    behalf of the caller (who must release on admission rollback or slot
    release). Eviction (:meth:`evict_for`, LRU) only drops blocks whose
    sole holder is the index itself -- blocks a live slot shares survive
    -- so feasibility is never worse than the no-cache engine: any pool
    pressure the index causes, the index can relieve.

    Single-threaded by contract, like the engine that owns it; the
    allocator calls it makes are individually atomic.
    """

    def __init__(self, alloc: BlockAllocator, block_size: int):
        if block_size < 1:
            raise ValueError("prefix cache needs block_size >= 1")
        self.alloc = alloc
        self.block_size = block_size
        self._by_key: Dict[bytes, int] = {}
        self._by_block: Dict[int, bytes] = {}
        self._lru: "OrderedDict[bytes, None]" = OrderedDict()
        self.evicted = 0  # structural counter; hit stats live in metrics

    @staticmethod
    def chain_keys(prompt, block_size: int) -> List[bytes]:
        """Chain hashes of the prompt's WHOLE blocks (trailing partial
        chunk excluded). Works for (S,) token prompts and (K, S)
        codebook prompts alike -- the chunk bytes cover every stream."""
        arr = np.ascontiguousarray(np.asarray(prompt, np.int64))
        n = arr.shape[-1] // block_size
        keys: List[bytes] = []
        h = b""
        for i in range(n):
            chunk = np.ascontiguousarray(
                arr[..., i * block_size:(i + 1) * block_size])
            h = hashlib.sha1(h + chunk.tobytes()).digest()
            keys.append(h)
        return keys

    def __len__(self) -> int:
        return len(self._by_key)

    def lookup(self, keys: Sequence[bytes]) -> List[int]:
        """Pool block ids of the longest cached prefix (a leading run of
        ``keys``). Each matched block is RETAINED for the caller, so the
        blocks cannot be evicted or freed between this lookup and the
        slot mapping them; release them on rollback."""
        blocks: List[int] = []
        for key in keys:
            b = self._by_key.get(key)
            if b is None:
                break
            blocks.append(b)
        if blocks:
            self.alloc.retain(blocks)
            for key in keys[: len(blocks)]:
                self._lru.move_to_end(key)
        return blocks

    def register(self, keys: Sequence[bytes],
                 blocks: Sequence[int]) -> int:
        """Publish freshly written full prompt blocks; the index takes
        one reference each. A key that is already registered keeps its
        existing block (the newcomer stays slot-private) -- that is the
        CoW case, where the forked copy must not displace the shared
        original. Returns the number of newly registered blocks."""
        n = 0
        for key, blk in zip(keys, blocks):
            if key in self._by_key:
                self._lru.move_to_end(key)
                continue
            self.alloc.retain([blk])
            self._by_key[key] = blk
            self._by_block[blk] = key
            self._lru[key] = None
            n += 1
        return n

    def evict_for(self, n_blocks: int) -> int:
        """Drop LRU index-only entries until ``n_blocks`` can be
        reserved (or nothing evictable remains). Blocks shared with a
        live slot (refcount > 1) are skipped; they become evictable once
        the slot releases. Returns the number of blocks freed."""
        freed = 0
        for key in list(self._lru):
            if self.alloc.can_reserve(n_blocks):
                break
            blk = self._by_key[key]
            if self.alloc.refcount(blk) > 1:
                continue
            del self._by_key[key]
            del self._by_block[blk]
            del self._lru[key]
            self.alloc.release([blk])
            freed += 1
        self.evicted += freed
        return freed


def blocks_needed(rows: int, block_size: int) -> int:
    """ceil(rows / block_size): pool blocks covering ``rows`` cache rows."""
    if rows <= 0:
        return 0
    return -(-rows // block_size)


def default_buckets(max_len: int, *, lo: int = 4) -> Tuple[int, ...]:
    """Powers of two from ``lo`` up to and including ``max_len``.

    Bounds the number of prefill traces at O(log max_len) under arbitrary
    traffic while wasting at most ~2x padded positions per prompt.
    """
    out: List[int] = []
    b = lo
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(out)


def resolve_buckets(
    buckets: Optional[Sequence[int]], max_len: int
) -> Tuple[int, ...]:
    """Normalize a user bucket list: clip to max_len, sort, always
    include max_len so every admissible prompt has a bucket. ``None``
    picks the power-of-two default; an empty sequence disables bucketing
    (the caller prefills at exact length)."""
    if buckets is None:
        return default_buckets(max_len)
    if not list(buckets):
        return ()  # only an EXPLICITLY empty list disables bucketing
    bl = sorted({int(b) for b in buckets if 0 < int(b) <= max_len})
    if not bl or bl[-1] != max_len:
        bl.append(max_len)
    return tuple(bl)


def pick_bucket(length: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= length (exact length when bucketing is off)."""
    for b in buckets:
        if b >= length:
            return b
    return length
