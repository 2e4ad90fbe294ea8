"""Radix prefix index: host-side trie mapping prompts to cached blocks.

The paged pool (PR 10) made the KV cache block-structured; refcounts
(PR 12) made full blocks shareable.  This module is the lookup structure
that turns those two facts into a TTFT lever: a trie over token ids at
**block granularity** — each node is exactly ``block_size`` tokens and
holds the physical block id whose KV rows were produced by prefilling
those tokens at that absolute position.  An arriving prompt walks the
trie (:meth:`PrefixIndex.match`), claims the matched blocks by ref-bump,
and prefills only the suffix.

Why the cached KV is bitwise-safe to adopt: chunk boundaries in the
engine's prefill program are **absolute positions** (chunk k covers
``[k*CH, (k+1)*CH)``), so any two requests that agree on tokens
``[0, n)`` run byte-identical prefill chunks over that range and write
byte-identical KV rows.  The block a node holds is therefore exactly
what the claiming request would have computed itself — which is what
keeps every stream bitwise equal to the same request served alone with
the cache off.  Two corollaries the engine relies on:

* the trie is keyed by **adapter id at the root** — a LoRA delta changes
  K/V content, so prompts prefilled under different adapters must never
  share blocks even when token-identical;
* the trie is NOT keyed by tenant — token-identical prompts share across
  tenants by design.  Sharing is a capacity optimisation, not a privacy
  boundary (docs/serving.md spells out the non-guarantees).

The index itself holds a reference on every cached block (holder id
:data:`CACHE_RID`), so a finished request's prompt blocks survive it.
Eviction is **LRU leaf-first**: only a leaf node whose block has no
other holder (refcount 1 — just the cache) may be dropped, which frees
deepest, coldest suffixes first and never yanks a block out from under
a resident request.  All bookkeeping is deterministic: the LRU clock is
a logical counter bumped on every match/insert touch, never wall time.

On snapshot/restore the trie is deliberately NOT serialized: the pool's
device state is restored by re-prefilling continuations, and the trie
rebuilds itself from those same deterministic prefills — host state
derived from token ids needs no bytes in the snapshot.
"""

from __future__ import annotations

from .paged_cache import BlockPool

# Holder id under which the index refcounts cached blocks.  Negative and
# distinct from any request id (rids are non-negative; the engine's
# chaos-burst synthetic rids are >= 1000) and from the engine's
# _CHAOS_RID (-7).
CACHE_RID = -2


class _Node:
    __slots__ = ("key", "block", "parent", "children", "touched", "host")

    def __init__(self, key, block, parent, touched, host=None):
        self.key = key          # tuple of block_size token ids
        self.block = block      # physical block id, or None when spilled
        self.parent = parent    # _Node or a root dict's owner (None)
        self.children = {}      # key tuple -> _Node
        self.touched = touched  # logical LRU clock value
        self.host = host        # host BlockStore id when spilled, else None


class PrefixIndex:
    """Block-granularity radix trie over (adapter, token ids)."""

    def __init__(self, block_size: int):
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.block_size = block_size
        self._roots: dict[int, dict] = {}  # adapter -> {key: _Node}
        self._clock = 0
        self._count = 0

    @property
    def size(self) -> int:
        """Number of cached blocks (== trie nodes)."""
        return self._count

    def _touch(self, node: _Node) -> None:
        self._clock += 1
        node.touched = self._clock

    def match(self, tokens, adapter: int = 0) -> list[int]:
        """Longest cached prefix of ``tokens``: the block ids, in logical
        order, of consecutive matched full blocks from position 0.  Every
        matched node is LRU-touched.  A spilled node (host tier) breaks
        the chain — callers without a :class:`BlockStore` can only adopt
        device-resident blocks; hierarchy-aware callers use
        :meth:`match_nodes`."""
        hit: list[int] = []
        for node in self.match_nodes(tokens, adapter):
            if node.block is None:
                break
            hit.append(node.block)
        return hit

    def match_nodes(self, tokens, adapter: int = 0) -> list:
        """Like :meth:`match` but returns the ``_Node`` chain itself,
        including spilled nodes (``node.block is None``,
        ``node.host`` set) — the hierarchy-aware claim path promotes
        those by swap-in.  Every matched node is LRU-touched."""
        bs = self.block_size
        children = self._roots.get(adapter)
        hit: list = []
        if children is None:
            return hit
        toks = list(tokens)
        for i in range(len(toks) // bs):
            key = tuple(int(t) for t in toks[i * bs:(i + 1) * bs])
            node = children.get(key)
            if node is None:
                break
            self._touch(node)
            hit.append(node)
            children = node.children
        return hit

    def insert(self, tokens, blocks: list[int], adapter: int = 0, *,
               pool: BlockPool, store=None) -> int:
        """Cache the full blocks of a finished prefill.

        ``blocks[i]`` holds the KV of ``tokens[i*bs:(i+1)*bs]``; only
        the first ``len(tokens) // bs`` FULL blocks are insertable (a
        partial block is still written by decode — never shareable).
        An existing node wins: if a prefix is already cached (two
        identical prompts prefilled concurrently), the incumbent block
        stays and the newcomer's private block is simply not cached.
        Exception: a SPILLED incumbent is repointed at the newcomer's
        device block (a free promotion — the fresh prefill just rebuilt
        the same bytes on device, so pass ``store`` to let the host copy
        go).  New nodes ref-bump their block for :data:`CACHE_RID`.
        Returns the number of nodes created."""
        bs = self.block_size
        n_full = min(len(tokens) // bs, len(blocks))
        children = self._roots.setdefault(adapter, {})
        parent = None
        created = 0
        toks = list(tokens)
        for i in range(n_full):
            key = tuple(int(t) for t in toks[i * bs:(i + 1) * bs])
            node = children.get(key)
            if node is None:
                self._clock += 1
                node = _Node(key, blocks[i], parent, self._clock)
                pool.share(CACHE_RID, [node.block])
                children[key] = node
                self._count += 1
                created += 1
            else:
                if node.block is None and store is not None:
                    pool.share(CACHE_RID, [blocks[i]])
                    store.free(CACHE_RID, [node.host])
                    node.block = blocks[i]
                    node.host = None
                self._touch(node)
            parent = node
            children = node.children
        return created

    def insert_spilled(self, tokens, host_id: int,
                       adapter: int = 0) -> bool:
        """Index ``host_id`` (a host-tier block already held for
        :data:`CACHE_RID`) as the node for the LAST full block of
        ``tokens`` — the warm-restore path, where cache contents arrive
        from disk straight into the host tier and promote on demand.
        All ancestor nodes must already exist (callers feed paths in
        depth order).  Returns False (incumbent wins, caller still owns
        the host hold) when the node already exists or an ancestor is
        missing."""
        bs = self.block_size
        toks = list(tokens)
        n_full = len(toks) // bs
        if n_full < 1:
            return False
        children = self._roots.setdefault(adapter, {})
        parent = None
        for i in range(n_full - 1):
            key = tuple(int(t) for t in toks[i * bs:(i + 1) * bs])
            node = children.get(key)
            if node is None:
                return False
            parent = node
            children = node.children
        key = tuple(int(t) for t in toks[(n_full - 1) * bs:n_full * bs])
        if key in children:
            return False
        self._clock += 1
        children[key] = _Node(key, None, parent, self._clock,
                              host=host_id)
        self._count += 1
        return True

    def walk(self):
        """Yield ``(adapter, path_tokens, node)`` for every node, parents
        strictly before children; ``path_tokens`` is the full token tuple
        from the root through the node (``depth * block_size`` ids).
        Deterministic order (insertion order of dicts) — the persistence
        path relies on parents-first so :meth:`insert_spilled` can replay
        it."""
        for adapter, children in self._roots.items():
            stack = [((), n) for n in reversed(list(children.values()))]
            while stack:
                prefix, node = stack.pop()
                path = prefix + node.key
                yield adapter, path, node
                stack.extend(
                    (path, c) for c in reversed(list(node.children.values())))

    def stats(self) -> dict:
        """Trie-shape snapshot for the metrics plane
        (``obs.metrics.absorb_prefix``) — pure reads, no LRU touches."""
        leaves = 0
        depth = 0
        spilled = 0
        for children in self._roots.values():
            stack = [(n, 1) for n in children.values()]
            while stack:
                node, d = stack.pop()
                depth = max(depth, d)
                if node.block is None:
                    spilled += 1
                if node.children:
                    stack.extend(
                        (c, d + 1) for c in node.children.values())
                else:
                    leaves += 1
        return {
            "nodes": self._count,
            "leaves": leaves,
            "max_depth": depth,
            "adapters": len(self._roots),
            "spilled": spilled,
        }

    def _evictable(self, adapter: int, node: _Node,
                   pool: BlockPool) -> bool:
        return (not node.children and node.block is not None
                and pool.refcount(node.block) == 1)

    def evict_one(self, pool: BlockPool) -> int | None:
        """Drop the least-recently-touched evictable LEAF (block held by
        nobody but the cache) and release its block.  Returns the freed
        block id, or None when nothing can be evicted."""
        victim = None
        victim_adapter = None
        for adapter, children in self._roots.items():
            stack = list(children.values())
            while stack:
                node = stack.pop()
                stack.extend(node.children.values())
                if self._evictable(adapter, node, pool):
                    if victim is None or node.touched < victim.touched:
                        victim = node
                        victim_adapter = adapter
        if victim is None:
            return None
        siblings = (victim.parent.children if victim.parent is not None
                    else self._roots[victim_adapter])
        del siblings[victim.key]
        self._count -= 1
        pool.free(CACHE_RID, [victim.block])
        return victim.block

    def demote_one(self, pool: BlockPool, demote) -> int | None:
        """Spill the least-recently-touched device-resident node whose
        block is held by nobody but the cache, via ``demote`` — a
        callable ``(block_id) -> host_id | None`` (the scheduler's
        d2h/dedup helper, which also drops the cache's pool hold on
        success).  Unlike :meth:`evict_one` there is NO leaf requirement:
        demotion preserves trie structure (the node stays, pointing at
        the host tier), so an interior cold block can make room without
        orphaning its descendants.  Returns the freed device block id,
        or None when nothing is demotable or the host tier is full."""
        victim = None
        for adapter, children in self._roots.items():
            stack = list(children.values())
            while stack:
                node = stack.pop()
                stack.extend(node.children.values())
                if (node.block is not None
                        and pool.refcount(node.block) == 1):
                    if victim is None or node.touched < victim.touched:
                        victim = node
        if victim is None:
            return None
        h = demote(victim.block)
        if h is None:
            return None
        freed = victim.block
        victim.block = None
        victim.host = h
        return freed

    def demote_many(self, pool: BlockPool, demote_batch,
                    limit: int = 8) -> list[int]:
        """Batched :meth:`demote_one`: spill up to ``limit`` of the
        least-recently-touched demotable nodes in ONE ``demote_batch``
        call — ``(block_ids) -> [host_id | None]``, parallel results
        (None = host tier full; that node stays resident).  Spilling a
        few extra cold blocks per pressure event amortizes the d2h
        dispatch overhead and pre-frees headroom for the allocations
        that tend to follow the first.  Returns the freed device block
        ids (possibly empty)."""
        cands = []
        for children in self._roots.values():
            stack = list(children.values())
            while stack:
                node = stack.pop()
                stack.extend(node.children.values())
                if (node.block is not None
                        and pool.refcount(node.block) == 1):
                    cands.append(node)
        if not cands:
            return []
        cands.sort(key=lambda n: n.touched)
        victims = cands[:limit]
        freed = []
        for node, h in zip(victims,
                           demote_batch([n.block for n in victims])):
            if h is None:
                continue
            freed.append(node.block)
            node.block = None
            node.host = h
        return freed

    def drop(self, pool: BlockPool, store=None) -> int:
        """Release every cached block — device holds AND (with ``store``)
        host-tier holds of spilled nodes — and empty the trie (engine
        close / restore).  Returns the number of blocks released."""
        freed = 0
        for children in self._roots.values():
            stack = list(children.values())
            while stack:
                node = stack.pop()
                stack.extend(node.children.values())
                if node.block is not None:
                    pool.free(CACHE_RID, [node.block])
                elif store is not None:
                    store.free(CACHE_RID, [node.host])
                freed += 1
        self._roots = {}
        self._count = 0
        return freed
