"""Ref-counted fixed-size KV-block allocator with hash-based prefix reuse.

The pool owns ``num_blocks`` blocks of ``block_size`` token positions each
(the device-side storage is the engine's problem; the pool is pure host-side
bookkeeping).  Block 0 is the reserved NULL block: it is never allocated,
and freed slots point their block tables at it so stale one-hot decode
writes land in garbage nobody reads.

Every block is in exactly one of three states:

    FREE      ref == 0, not hashed     -> on the free list
    ACTIVE    ref >= 1                 -> owned by one or more requests
    CACHED    ref == 0, hashed         -> evictable prefix-cache entry

Prefix reuse is content-addressed: full prompt blocks are registered under a
chained hash (``hash(parent_hash, tokens_of_block)``), so a lookup of a new
prompt walks the chain and returns the longest run of already-resident
blocks.  A hit bumps the block's refcount (CACHED -> ACTIVE) and skips its
prefill recompute.  When the free list runs dry, CACHED blocks are evicted
LRU-first (``EV_EVICT`` marks each eviction in the trace).

Every allocator decision is observable: ``EV_BLOCKS_FREE`` /
``EV_BLOCKS_CACHED`` counters after each state change, ``EV_EVICT`` per
evicted block — so a Paraver timeline shows memory pressure next to queue
depth (the Frontier-workflow lesson: capacity, not FLOPs, caps throughput).
"""
from __future__ import annotations

import collections

from repro_torch.core import events as ev

NULL_BLOCK = 0


def _block_hash(parent_hash: int, tokens) -> int:
    """Chained content hash of one full block of prompt tokens."""
    return hash((parent_hash, tuple(int(t) for t in tokens)))


class BlockPool:
    """Host-side bookkeeping for a pool of fixed-size KV-cache blocks."""

    def __init__(self, num_blocks: int, block_size: int, *, tracer=None,
                 kv_dtype: str = "fp16", block_bytes: int = 0):
        if num_blocks < 2:
            raise ValueError("num_blocks must be >= 2 (block 0 is reserved)")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.tracer = tracer
        # storage metadata: pure reporting (the device-side leaves are the
        # engine's problem) — kv_dtype names the pool storage, block_bytes
        # is bytes per block across all layers/leaves incl. scale leaves
        self.kv_dtype = kv_dtype
        self.block_bytes = int(block_bytes)
        # block 0 reserved as NULL: never allocated, never freed
        self._free: collections.deque[int] = collections.deque(
            range(1, self.num_blocks))
        self._ref = [0] * self.num_blocks
        self._hash_of = [None] * self.num_blocks  # block -> registered hash
        # hash -> block, insertion/touch order == LRU order for eviction
        self._hashed: collections.OrderedDict[int, int] = collections.OrderedDict()
        self.stats = {"allocs": 0, "evictions": 0, "hit_blocks": 0,
                      "forks": 0, "cow_copies": 0}
        if tracer is not None:
            for code in (ev.EV_BLOCKS_FREE, ev.EV_BLOCKS_CACHED,
                         ev.EV_BLOCKS_ACTIVE, ev.EV_BLOCK_DTYPE,
                         ev.EV_POOL_ACTIVE_KIB, ev.EV_BLOCKS_SHARED):
                tracer.register(code, ev.SERVE_CTR_LABELS[code])
            tracer.register(ev.EV_EVICT, "KV block evicted (block id)")
            # punctual, once: the pool's storage dtype as a counter value so
            # a .prv reader can tell an int8 run from an fp16 run cold
            tracer.emit(ev.EV_BLOCK_DTYPE,
                        ev.BLOCK_DTYPE_IDS.get(kv_dtype, 0))

    # ------------------------------------------------------------------
    # state queries
    # ------------------------------------------------------------------
    def num_free(self) -> int:
        return len(self._free)

    def num_cached(self) -> int:
        """Evictable blocks: hashed prefix-cache entries with refcount 0."""
        return sum(1 for bid in self._hashed.values() if self._ref[bid] == 0)

    def num_active(self) -> int:
        return sum(1 for r in self._ref[1:] if r > 0)

    def available(self) -> int:
        """Blocks an admission could claim: free + evictable."""
        return self.num_free() + self.num_cached()

    def ref(self, bid: int) -> int:
        return self._ref[bid]

    def num_shared(self) -> int:
        """Blocks referenced by more than one request (CoW-shared): the
        gauge that proves n-way forks alias the prompt instead of copying
        it.  A shared block must be copied-on-write before any fork may
        scatter into it."""
        return sum(1 for r in self._ref[1:] if r > 1)

    def blocks_for(self, num_tokens: int) -> int:
        """Blocks spanning cache positions [0, num_tokens)."""
        return -(-int(num_tokens) // self.block_size)

    # ------------------------------------------------------------------
    # alloc / free
    # ------------------------------------------------------------------
    def _emit_gauges(self):
        if self.tracer is not None:
            self.tracer.emit(ev.EV_BLOCKS_FREE, self.num_free())
            self.tracer.emit(ev.EV_BLOCKS_CACHED, self.num_cached())
            active = self.num_active()
            self.tracer.emit(ev.EV_BLOCKS_ACTIVE, active)
            self.tracer.emit(ev.EV_BLOCKS_SHARED, self.num_shared())
            self.tracer.emit(ev.EV_BLOCK_DTYPE,
                             ev.BLOCK_DTYPE_IDS.get(self.kv_dtype, 0))
            if self.block_bytes:
                self.tracer.emit(ev.EV_POOL_ACTIVE_KIB,
                                 active * self.block_bytes // 1024)

    def _evict_one(self) -> int | None:
        """Evict the LRU cached block (refcount 0), returning it reusable."""
        for h, bid in self._hashed.items():
            if self._ref[bid] == 0:
                del self._hashed[h]
                self._hash_of[bid] = None
                self.stats["evictions"] += 1
                if self.tracer is not None:
                    self.tracer.emit(ev.EV_EVICT, bid)
                return bid
        return None

    def alloc(self, n: int = 1) -> list[int]:
        """Claim ``n`` blocks (refcount 1 each), evicting cached blocks LRU
        as needed.  Raises ``MemoryError`` if the pool cannot satisfy the
        request — the caller preempts and retries."""
        if n > self.available():
            raise MemoryError(
                f"pool exhausted: need {n}, available {self.available()} "
                f"({self.num_free()} free + {self.num_cached()} cached)")
        out = []
        for _ in range(n):
            if self._free:
                bid = self._free.popleft()
            else:
                bid = self._evict_one()
                assert bid is not None  # guarded by the available() check
            self._ref[bid] = 1
            out.append(bid)
        self.stats["allocs"] += len(out)
        self._emit_gauges()
        return out

    def incref(self, bids) -> None:
        for bid in bids:
            if bid == NULL_BLOCK:
                raise ValueError("cannot reference the NULL block")
            self._ref[bid] += 1
        self._emit_gauges()

    def free(self, bids) -> None:
        """Drop one reference per block.  At refcount 0 a hashed block
        becomes CACHED (evictable, still serving prefix hits); an unhashed
        block returns to the free list.  Double-free raises."""
        for bid in bids:
            if bid == NULL_BLOCK:
                continue  # table padding — nothing to release
            if self._ref[bid] <= 0:
                raise ValueError(f"double free of block {bid}")
            self._ref[bid] -= 1
            if self._ref[bid] == 0 and self._hash_of[bid] is None:
                self._free.append(bid)
        self._emit_gauges()

    # ------------------------------------------------------------------
    # copy-on-write forking
    # ------------------------------------------------------------------
    def fork(self, bids) -> list[int]:
        """Alias one child's view of a parent's block list: every real
        block (full prompt blocks AND the partial tail) gains one
        reference; nothing is copied.  The returned list is the child's own
        table — identical block ids, independently owned refs.  Writes into
        a shared block are deferred to :meth:`cow`: the partial tail is the
        only block a forked request ever writes while shared, so n-way
        sampling costs n-1 tail copies and zero full-block copies."""
        real = [b for b in bids if b != NULL_BLOCK]
        self.incref(real)
        self.stats["forks"] += 1
        return list(bids)

    def cow(self, bid: int) -> tuple[int, bool]:
        """Copy-on-write gate before scattering into ``bid``.  A privately
        held block (ref <= 1) is written in place — ``(bid, False)``.  A
        shared block must not be scribbled under its other holders: this
        writer's reference moves to a freshly allocated block —
        ``(fresh, True)`` — and the caller copies the device-side contents
        ``bid -> fresh`` before dispatching the write.  The last holder to
        write inherits the original in place (ref drops back to 1 as the
        earlier writers peel off), so n holders cost exactly n-1 copies.
        May raise ``MemoryError`` like :meth:`alloc` — callers preempt and
        retry under the same discipline."""
        if self._ref[bid] <= 1:
            return bid, False
        fresh = self.alloc(1)[0]
        # drop this writer's reference on the shared source; the remaining
        # holders keep theirs (a hashed source can even stay CACHED-able)
        self.free([bid])
        self.stats["cow_copies"] += 1
        return fresh, True

    # ------------------------------------------------------------------
    # prefix cache
    # ------------------------------------------------------------------
    def hash_chain(self, tokens) -> list[int]:
        """Chained hashes of every FULL block of ``tokens`` (partial tail
        blocks are never shared — they are still being written)."""
        bs = self.block_size
        out, parent = [], 0
        for j in range(len(tokens) // bs):
            parent = _block_hash(parent, tokens[j * bs:(j + 1) * bs])
            out.append(parent)
        return out

    def resident(self, h: int) -> int | None:
        """Block id registered under chain hash ``h`` (ACTIVE or CACHED),
        or None.  Pure query — refcounts and LRU order untouched."""
        return self._hashed.get(h)

    def resident_hashes(self) -> list[int]:
        """Every registered chain hash with content still in the pool —
        what a router can expect this engine to prefix-hit."""
        return list(self._hashed.keys())

    def lookup(self, tokens) -> list[int]:
        """Longest run of resident prefix blocks for ``tokens``.  Capped so
        at least one token remains to prefill (the tail produces the next-
        token logits).  Pure query: refcounts untouched — call
        :meth:`claim` on the returned blocks to pin them."""
        return self.lookup_with_hashes(tokens)[0]

    def lookup_with_hashes(self, tokens) -> tuple[list[int], list[int]]:
        """(hits, full hash chain) in one pass — admission needs both (the
        chain is reused to register fresh blocks after prefill), and the
        chained hash is the O(prompt) part worth not recomputing."""
        hashes = self.hash_chain(tokens)
        return self.resolve_hits(hashes, len(tokens)), hashes

    def resolve_hits(self, hashes, num_tokens: int) -> list[int]:
        """Residency walk over a precomputed chain (the chain is immutable
        for a given prompt; only residency goes stale — a blocked queue
        head re-walks this without re-hashing)."""
        usable = hashes
        if hashes and len(hashes) * self.block_size == num_tokens:
            usable = hashes[:-1]  # keep >= 1 tail token to prefill
        out = []
        for h in usable:
            bid = self._hashed.get(h)
            if bid is None:
                break
            out.append(bid)
        return out

    def claim(self, bids) -> None:
        """Pin prefix-hit blocks (CACHED -> ACTIVE) and touch their LRU
        position so concurrently-useful prefixes survive eviction longest."""
        for bid in bids:
            h = self._hash_of[bid]
            if h is None:
                raise ValueError(f"block {bid} is not a registered prefix block")
            self._hashed.move_to_end(h)
        self.incref(bids)
        self.stats["hit_blocks"] += len(bids)

    def register(self, bid: int, h: int) -> None:
        """Publish a freshly-written full prompt block under its chain hash.
        First writer wins: a concurrent duplicate keeps its private block."""
        if h not in self._hashed and self._hash_of[bid] is None:
            self._hashed[h] = bid
            self._hash_of[bid] = h
        self._emit_gauges()

    # ------------------------------------------------------------------
    def check_invariants(self) -> None:
        """Conservation + state-exclusivity (used by the property tests)."""
        free = set(self._free)
        assert len(free) == len(self._free), "free list has duplicates"
        assert NULL_BLOCK not in free, "NULL block leaked into the free list"
        cached = {b for b in self._hashed.values() if self._ref[b] == 0}
        active = {b for b in range(1, self.num_blocks) if self._ref[b] > 0}
        assert not free & active and not free & cached and not active & cached
        assert len(free) + len(active) + len(cached) == self.num_blocks - 1
        for h, bid in self._hashed.items():
            assert self._hash_of[bid] == h
