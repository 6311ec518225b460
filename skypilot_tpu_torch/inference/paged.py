"""Host-side bookkeeping for the paged KV cache: block pool + prefix cache.

The port's copy of ``BlockPool``, ``PrefixCache``, ``chain_digests``,
``BlockImporter``, ``adapter_chain_root`` and ``AdapterPagePool`` from
``skypilot_tpu/inference/paged.py`` (host-side Python, unchanged).
The device side (``models/decode.py`` ``PagedKVCache``) is pure data;
the policy lives here, on the serving-loop thread:

* ``BlockPool`` — refcounted free-list allocator over pool block ids.
  Block 0 is reserved as the null block (masked/inactive writes land
  there; unused table entries point at it), so it is never handed out.
* ``PrefixCache`` — digest-chain keyed, read-only, block-granular
  sharing of prompt prefixes: a full block of prompt tokens is keyed by
  (parent digest, its token tuple), so a shared system prompt prefills
  once and later requests reference the same pool blocks. Only FULL
  prompt blocks are shared; a slot's tail block is always private.
* ``BlockImporter`` — the refcount-exact begin/commit/abort of a KV
  block import (disaggregated serving's decode side): an aborted import
  leaves the pool and the prefix cache exactly as they were.
* ``AdapterPagePool`` — which LoRA adapter owns which device page slot;
  a resident adapter charges blocks against the same ``BlockPool``.

All structures are single-threaded by design — they are only touched
from the engine's serving loop (``PrefixCache.resident_chain`` is the
read-only exception).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, List, Optional, Sequence, Tuple

NULL_BLOCK = 0


class BlockPool:
    """Refcounted allocator over pool block ids 1..num_blocks-1."""

    def __init__(self, num_blocks: int) -> None:
        if num_blocks < 2:
            raise ValueError('BlockPool needs >= 2 blocks '
                             '(block 0 is the reserved null block)')
        self.num_blocks = num_blocks
        # pop() order: 1, 2, 3, ... — deterministic for tests/benches.
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._ref = [0] * num_blocks
        # Bumped on every alloc/incref/decref: lets the engine skip
        # re-running admission work for an HBM-blocked request until
        # pool state could actually have changed.
        self.version = 0

    @property
    def total_blocks(self) -> int:
        """Allocatable blocks (the null block is not)."""
        return self.num_blocks - 1

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def alloc(self) -> Optional[int]:
        """One block at refcount 1, or None when the pool is empty."""
        if not self._free:
            return None
        block = self._free.pop()
        self._ref[block] = 1
        self.version += 1
        return block

    def incref(self, block: int) -> None:
        if block == NULL_BLOCK or self._ref[block] <= 0:
            raise ValueError(f'incref of unallocated block {block}')
        self._ref[block] += 1
        self.version += 1

    def decref(self, block: int) -> None:
        if block == NULL_BLOCK or self._ref[block] <= 0:
            raise ValueError(f'double free of block {block}')
        self._ref[block] -= 1
        self.version += 1
        if self._ref[block] == 0:
            self._free.append(block)

    def refcount(self, block: int) -> int:
        return self._ref[block]


@dataclasses.dataclass
class _PrefixEntry:
    block: int
    parent: int           # parent digest (0 = chain root)
    tokens: Tuple[int, ...]


class PrefixCache:
    """Digest-chain keyed read-only block sharing.

    Keying: block i of a prompt is identified by a rolling digest
    ``hash((parent_digest, tokens[i*bs:(i+1)*bs]))``. Lookups walk the
    chain from the root and verify BOTH the stored token tuple and the
    parent link before trusting an entry, so hash collisions degrade to
    a cache miss, never to wrong KV. Entries are LRU-ordered; eviction
    drops the entry's block reference back to the pool.
    """

    def __init__(self, pool: BlockPool, block_size: int,
                 max_entries: int = 4096) -> None:
        self._pool = pool
        self._block_size = block_size
        self._max_entries = max_entries
        self._entries: 'OrderedDict[int, _PrefixEntry]' = OrderedDict()

    @property
    def cached_blocks(self) -> int:
        return len(self._entries)

    @staticmethod
    def _digest(parent: int, tokens: Tuple[int, ...]) -> int:
        return hash((parent, tokens))

    def lookup(self, ids: Sequence[int], limit_tokens: int,
               root: int = 0) -> List[int]:
        """Longest cached full-block prefix of ``ids`` covering at most
        ``limit_tokens`` tokens. Increfs and returns the matched block
        ids (caller owns the references). ``root`` seeds the chain
        (0 = base model; adapter-salted roots keep per-adapter KV
        chains disjoint)."""
        bs = self._block_size
        matched: List[int] = []
        parent = root
        for i in range(min(len(ids), limit_tokens) // bs):
            tokens = tuple(ids[i * bs:(i + 1) * bs])
            digest = self._digest(parent, tokens)
            entry = self._entries.get(digest)
            if (entry is None or entry.tokens != tokens or
                    entry.parent != parent):
                break
            self._entries.move_to_end(digest)
            self._pool.incref(entry.block)
            matched.append(entry.block)
            parent = digest
        return matched

    def resident_chain(self, ids: Sequence[int],
                       root: int = 0) -> List[int]:
        """Chain digests of the cached full-block prefix of ``ids`` —
        strictly read-only (no incref, no LRU touch), so the decode
        side of a KV migration can plan its delta manifest from
        OUTSIDE the serving loop. Residency can change before the
        import lands; the import transaction re-walks the chain and
        falls back to re-prefill on a shrink."""
        bs = self._block_size
        out: List[int] = []
        parent = root
        for i in range(len(ids) // bs):
            tokens = tuple(ids[i * bs:(i + 1) * bs])
            digest = self._digest(parent, tokens)
            entry = self._entries.get(digest)
            if (entry is None or entry.tokens != tokens or
                    entry.parent != parent):
                break
            out.append(digest)
            parent = digest
        return out

    def insert(self, ids: Sequence[int], blocks: Sequence[int],
               root: int = 0) -> None:
        """Register the full blocks of a freshly prefilled prompt.

        ``blocks`` is the slot's block list (shared prefix first, then
        private). Blocks already cached along the chain are skipped —
        the existing shared copy stays canonical. ``root`` must match
        the salt the prompt was prefilled under (see :meth:`lookup`)."""
        bs = self._block_size
        parent = root
        for i in range(len(ids) // bs):
            if i >= len(blocks):
                break
            tokens = tuple(ids[i * bs:(i + 1) * bs])
            digest = self._digest(parent, tokens)
            entry = self._entries.get(digest)
            if (entry is not None and entry.tokens == tokens and
                    entry.parent == parent):
                self._entries.move_to_end(digest)
                parent = digest
                continue
            if entry is not None:
                # Digest collision with a different chain: leave the
                # resident entry alone (collisions are misses, never
                # corruption) and stop extending this chain.
                break
            self._pool.incref(blocks[i])
            self._entries[digest] = _PrefixEntry(
                block=blocks[i], parent=parent, tokens=tokens)
            parent = digest
            while len(self._entries) > self._max_entries:
                self.evict_one()

    @property
    def reclaimable_blocks(self) -> int:
        """Entries whose block only the cache holds — evicting one of
        these actually frees a pool block (entries shared with live
        slots free nothing until the slots finish)."""
        return sum(1 for e in self._entries.values()
                   if self._pool.refcount(e.block) == 1)

    def evict_one(self) -> bool:
        """Drop the least-recently-used entry (and its block ref).
        Returns False when the cache is empty. Used for the entry-count
        cap; under POOL pressure use ``evict_reclaimable`` instead."""
        if not self._entries:
            return False
        _, entry = self._entries.popitem(last=False)
        self._pool.decref(entry.block)
        return True

    def evict_reclaimable(self) -> bool:
        """Evict the LRU entry whose block the cache alone holds, so
        the eviction actually returns a block to the free list.
        Returns False when no entry is reclaimable — evicting entries
        shared with active slots would wipe reusable prefix chains
        without freeing a single block."""
        for digest, entry in self._entries.items():  # LRU order
            if self._pool.refcount(entry.block) == 1:
                del self._entries[digest]
                self._pool.decref(entry.block)
                return True
        return False

    def clear(self) -> None:
        while self.evict_one():
            pass


# ---------------------------------------------------------------------
# KV-block migration bookkeeping (disaggregated prefill/decode serving)
# ---------------------------------------------------------------------


def chain_digests(ids: Sequence[int], block_size: int,
                  root: int = 0) -> List[int]:
    """Rolling chain digest of every FULL block of ``ids`` — the same
    keying :class:`PrefixCache` uses, exported for the KV-migration
    delta manifest: a block is resident on the decode side iff its
    chain digest (and token tuple, verified by the cache walk) already
    has an entry there, so only non-resident blocks ever move.
    ``root`` carries the adapter salt so migrated adapter KV never
    aliases base-model chains."""
    out: List[int] = []
    parent = root
    for i in range(len(ids) // block_size):
        tokens = tuple(ids[i * block_size:(i + 1) * block_size])
        parent = PrefixCache._digest(parent, tokens)  # noqa: SLF001
        out.append(parent)
    return out


class BlockImporter:
    """All-or-nothing block acquisition for a KV-block import.

    A migration import must be *refcount-exact*: if the transfer dies
    mid-flight (peer death, corrupt payload, timeout), the pool and
    prefix cache must be returned to EXACTLY their pre-import state —
    same refcounts, same cached entries — so the request can fall back
    to a local re-prefill with zero leaked blocks (the r13 speculative
    rollback discipline, applied to migration).

    Usage::

        importer = BlockImporter(pool, prefix)
        got = importer.begin(ids, needed_total, block_size=bs)
        if got is None:       # pool can't fit it right now; nothing held
            ...
        blocks, n_resident = got
        try:
            ... copy the non-resident block payloads in ...
            importer.commit()     # refs now owned by the caller's slot
        except Exception:
            importer.abort()      # exact pre-import state restored
            raise
    """

    def __init__(self, pool: BlockPool,
                 prefix: Optional[PrefixCache] = None) -> None:
        self._pool = pool
        self._prefix = prefix
        self._resident: List[int] = []
        self._allocated: List[int] = []
        self._active = False

    @property
    def active(self) -> bool:
        return self._active

    def begin(self, ids: Sequence[int], needed_total: int, *,
              block_size: int,
              alloc: Optional[Callable[[], Optional[int]]] = None,
              root: int = 0
              ) -> Optional[Tuple[List[int], int]]:
        """Acquire ``needed_total`` blocks for token sequence ``ids``:
        the cached full-block prefix first (shared — increfed through
        the prefix cache, these blocks' payloads never move), then
        freshly allocated private blocks for the remainder. Returns
        ``(blocks, n_resident)``, or ``None`` when the pool cannot
        supply the private blocks right now — in which case NOTHING is
        retained (the failed attempt is invisible to the pool beyond
        its version counter).

        ``alloc`` overrides the raw allocator (the engine passes its
        prefix-evicting ``_alloc_block``)."""
        if self._active:
            raise RuntimeError('BlockImporter already has an open import')
        if alloc is None:
            alloc = self._pool.alloc
        resident: List[int] = []
        if self._prefix is not None:
            limit = min(len(ids), needed_total * block_size)
            resident = self._prefix.lookup(ids, limit_tokens=limit,
                                           root=root)
        self._resident = resident
        self._allocated = []
        self._active = True
        while len(resident) + len(self._allocated) < needed_total:
            block = alloc()
            if block is None:
                self.abort()
                return None
            self._allocated.append(block)
        return list(resident) + list(self._allocated), len(resident)

    def commit(self) -> None:
        """The import landed: the caller's slot now owns every
        reference this importer took."""
        self._resident = []
        self._allocated = []
        self._active = False

    def abort(self) -> None:
        """Undo every reference this import took, newest first —
        refcounts and prefix-cache entries end exactly where they were
        before :meth:`begin`. Idempotent; a no-op after commit."""
        for block in reversed(self._allocated):
            self._pool.decref(block)
        for block in reversed(self._resident):
            self._pool.decref(block)
        self._resident = []
        self._allocated = []
        self._active = False


# ---------------------------------------------------------------------
# Multi-LoRA unified paging (adapter weight pages in the KV pool)
# ---------------------------------------------------------------------


def adapter_chain_root(adapter: Optional[str]) -> int:
    """Prefix-chain root salt for an adapter (0 = base model).

    LoRA v-projection deltas make cached V rows adapter-specific, so
    each adapter's prefix chains must be disjoint from the base chains
    and from every other adapter's. Never 0 for a named adapter."""
    if not adapter:
        return 0
    return hash(('skyt-lora-root', adapter)) or 1


@dataclasses.dataclass
class _AdapterResidency:
    page: int             # device page-slot index (1..n_pages)
    blocks: List[int]     # charge blocks held against the shared pool
    pins: int = 0         # live slots currently decoding this adapter


class AdapterPagePool:
    """Host-side policy for adapter weight pages in the shared pool.

    The device side is a fixed stack of adapter page slots
    (``models/lora.init_adapter_pages``; page 0 = base model, all
    zeros). This class decides which adapter owns which page slot, and
    a resident adapter charges ``ceil(nbytes / block_bytes)`` blocks
    against the same :class:`BlockPool` the KV cache allocates from,
    held for as long as it is resident: KV pressure and adapter
    pressure share one budget.

    Refcount-exact: a failed admission leaves the pool untouched, and
    evicting every resident returns the pool to exactly its prior free
    count. A slot decoding with an adapter pins it; pinned adapters
    are never evicted, so a page in use is never overwritten.
    """

    def __init__(self, pool: BlockPool, n_pages: int,
                 block_bytes: int) -> None:
        if n_pages < 1:
            raise ValueError('AdapterPagePool needs >= 1 page slot')
        if block_bytes < 1:
            raise ValueError('block_bytes must be >= 1')
        self._pool = pool
        self.n_pages = n_pages
        self.block_bytes = block_bytes
        # pop() order 1, 2, ... — deterministic, page 0 is the base.
        self._free_pages: List[int] = list(range(n_pages, 0, -1))
        self._resident: 'OrderedDict[str, _AdapterResidency]' = \
            OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @property
    def resident_pages(self) -> int:
        return len(self._resident)

    @property
    def blocks_charged(self) -> int:
        return sum(len(r.blocks) for r in self._resident.values())

    def blocks_for(self, nbytes: int) -> int:
        """Charge-block count for an adapter of ``nbytes`` weights."""
        return max(1, -(-int(nbytes) // self.block_bytes))

    def resident_names(self) -> List[str]:
        return list(self._resident)

    def page_of(self, name: str) -> Optional[int]:
        """Page index if resident (no LRU touch, no hit counting)."""
        entry = self._resident.get(name)
        return entry.page if entry is not None else None

    def lookup(self, name: str) -> Optional[int]:
        """Residency check on the request path: bumps LRU recency and
        the hit/miss counters."""
        entry = self._resident.get(name)
        if entry is None:
            self.misses += 1
            return None
        self._resident.move_to_end(name)
        self.hits += 1
        return entry.page

    def admit(self, name: str, nbytes: int, *,
              alloc: Optional[Callable[[], Optional[int]]] = None,
              on_evict: Optional[Callable[[str], None]] = None
              ) -> Optional[int]:
        """Make ``name`` resident: claim a page slot (LRU-evicting idle
        adapters if every slot is taken) and the charge blocks.
        Returns the page index, or None when it can't fit right now
        (every page pinned, or the pool can't supply the charge blocks
        even after evicting idle adapters); a None return retains
        nothing. Raises when the adapter can never fit the pool.

        ``alloc`` overrides the raw allocator (the engine passes its
        prefix-evicting ``_alloc_block``); ``on_evict`` observes each
        LRU eviction BEFORE it mutates."""
        if name in self._resident:
            raise ValueError(f'adapter {name!r} is already resident')
        if alloc is None:
            alloc = self._pool.alloc
        need = self.blocks_for(nbytes)
        if need > self._pool.total_blocks:
            raise ValueError(
                f'adapter {name!r} needs {need} charge blocks; pool '
                f'has {self._pool.total_blocks} total')
        while not self._free_pages:
            if self.evict_lru(on_evict=on_evict) is None:
                return None
        blocks: List[int] = []
        try:
            while len(blocks) < need:
                block = alloc()
                if block is not None:
                    blocks.append(block)
                    continue
                if self.evict_lru(on_evict=on_evict) is None:
                    for held in reversed(blocks):
                        self._pool.decref(held)
                    return None
        except BaseException:
            # A raising alloc/on_evict must not leak the charge blocks
            # already held for this failed admission.
            for held in reversed(blocks):
                self._pool.decref(held)
            raise
        page = self._free_pages.pop()
        self._resident[name] = _AdapterResidency(page=page,
                                                 blocks=blocks)
        return page

    def evict_lru(self, on_evict: Optional[Callable[[str], None]] = None
                  ) -> Optional[str]:
        """Evict the least-recently-used UNPINNED resident: its page
        slot and charge blocks return to their free lists. Returns the
        evicted name, or None when every resident is pinned."""
        for name, entry in self._resident.items():   # LRU order
            if entry.pins:
                continue
            if on_evict is not None:
                on_evict(name)        # may raise; nothing mutated yet
            del self._resident[name]
            for block in reversed(entry.blocks):
                self._pool.decref(block)
            self._free_pages.append(entry.page)
            self.evictions += 1
            return name
        return None

    def pin(self, name: str) -> None:
        entry = self._resident.get(name)
        if entry is None:
            raise ValueError(f'pin of non-resident adapter {name!r}')
        entry.pins += 1
        # Pin state gates admissibility like refcounts do: bump the
        # pool version so blocked admission retries re-run.
        self._pool.version += 1

    def unpin(self, name: str) -> None:
        entry = self._resident.get(name)
        if entry is None or entry.pins <= 0:
            raise ValueError(f'unpin of unpinned adapter {name!r}')
        entry.pins -= 1
        self._pool.version += 1

    def pins(self, name: str) -> int:
        entry = self._resident.get(name)
        return entry.pins if entry is not None else 0

    def clear(self) -> None:
        """Evict every unpinned resident (teardown accounting)."""
        while self.evict_lru() is not None:
            pass
