"""Host-side bookkeeping for the paged KV cache: block pool + prefix cache.

The port's copy of ``BlockPool``, ``PrefixCache`` and ``chain_digests``
from ``skypilot_tpu/inference/paged.py`` (host-side Python, unchanged).
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

All structures are single-threaded by design — they are only touched
from the engine's serving loop. ``AdapterPagePool`` and
``BlockImporter`` (multi-LoRA, KV migration) are later slices.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import List, Sequence, Tuple

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
