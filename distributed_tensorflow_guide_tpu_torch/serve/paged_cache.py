"""Paged KV cache: a fixed pool of fixed-size blocks + per-request tables.

Every attention layer's cache is a POOL of ``num_blocks`` fixed-size
blocks shared by all resident requests, and each request owns a **block
table** — a row of physical block ids covering its logical positions
``[0, max_len)``.

* **host Python** (:class:`BlockPool`, :class:`BlockStore`) allocates,
  frees and evicts blocks — a free-list the scheduler drives between
  steps. These are copies of the JAX package's classes.
* **device code** (:func:`gather_view` / :func:`scatter_chunk`) reads
  and writes through the table: a gather by block id materialises a
  request's logical cache view, a scatter to row
  ``table[pos // bs] * bs + pos % bs`` writes a chunk **in place**.

Unallocated logical blocks point at the reserved **trash block** (the
pool's last id): inactive decode slots write there and the attention
mask hides anything read from it, so the step needs no branch on
liveness. The helpers are layout-agnostic (``seq_axis`` names the
blocked axis): the pool has the kernel layout ``(N, H, bs, hd)`` and
the int8 scale rows ``(N, H, 1, bs)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# --------------------------------------------------------------------------
# device-side: gather / scatter through a block table
# --------------------------------------------------------------------------


def gather_view(pool, tables, *, seq_axis: int):
    """Materialise per-request logical cache views from the pool.

    ``pool`` is ``(num_blocks, *dims)`` where ``dims[seq_axis - 1]`` is the
    block size; ``tables`` is ``(B, n)`` physical block ids. Returns
    ``(B, *dims)`` with the blocked axis expanded to ``n * block_size`` at
    ``seq_axis``.
    """
    g = pool[tables.long()]  # (B, n, *dims)
    g = torch.movedim(g, 1, seq_axis)
    shape = list(g.shape)
    merged = (shape[:seq_axis]
              + [shape[seq_axis] * shape[seq_axis + 1]]
              + shape[seq_axis + 2:])
    return g.reshape(merged)


def scatter_chunk(pool, chunk, tables, index, *, block_size: int,
                  seq_axis: int):
    """Write per-request chunks into the pool, in place, through the
    block tables.

    ``chunk`` is ``(B, *dims)`` with C positions along ``seq_axis``;
    request b's chunk lands at logical positions ``[index[b], index[b] +
    C)``, i.e. at block ``tables[b, p // bs]``, offset ``p % bs``.
    Several idle slots may all write into the trash block at the same
    rows; which of the duplicate writes wins is unspecified and harmless,
    because nothing ever reads the trash block unmasked. Returns ``pool``.
    """
    B = chunk.shape[0]
    C = chunk.shape[seq_axis]
    pos = (index.to(torch.int64)[:, None]
           + torch.arange(C, device=chunk.device)[None, :])  # (B, C)
    phys = torch.gather(tables.to(torch.int64), 1, pos // block_size)
    off = pos % block_size
    # advanced indices on axis 0 and seq_axis: the indexed shape is
    # (B * C, *the other axes in order)
    where = ((phys.reshape(-1),) + (slice(None),) * (seq_axis - 1)
             + (off.reshape(-1),))
    rows = torch.movedim(chunk, seq_axis, 1).reshape(
        (B * C,) + tuple(chunk.shape[1:seq_axis])
        + tuple(chunk.shape[seq_axis + 1:]))
    pool[where] = rows.to(pool.dtype)
    return pool


# --------------------------------------------------------------------------
# host-side: the allocator the scheduler drives
# --------------------------------------------------------------------------


@dataclasses.dataclass
class BlockPool:
    """Host-side block allocator: free-list + refcounted holder ledger.

    ``num_blocks`` includes the reserved trash block (the LAST id), which
    is never handed out — ``capacity`` is what requests can actually own.
    Deterministic: blocks are allocated lowest-id-first, so an identical
    request trace produces identical tables (the scheduler-determinism
    test pins this).

    Prefix sharing (PR 12) turns the per-block owner into a SET of
    holders: :meth:`alloc` creates a block with one holder, :meth:`share`
    ref-bumps an already-live block for a new holder (a request claiming
    a cached prefix, or the prefix index itself pinning a finished
    prefill's blocks), and :meth:`free` removes one holder — the block
    returns to the free list only when its refcount hits zero.  The
    ledger still makes aliasing structurally impossible: every free
    checks the caller actually holds the block, and a holder can never
    be added twice.  ``live_blocks`` counts DISTINCT live blocks, which
    is what makes the paged byte model charge a shared block once.
    """

    num_blocks: int
    block_size: int

    def __post_init__(self) -> None:
        if self.num_blocks < 2:
            raise ValueError("need >= 2 blocks (one is the trash block)")
        self._free: list[int] = sorted(range(self.num_blocks - 1),
                                       reverse=True)
        self._holders: dict[int, set[int]] = {}  # block id -> holder rids
        # invoked with the block id whenever a block's refcount hits 0
        # (the id is about to be re-handed-out and REWRITTEN) — the
        # spill tier uses this to invalidate its device->host content
        # dedup map the instant an association can go stale
        self.on_recycle = None

    @property
    def trash_block(self) -> int:
        return self.num_blocks - 1

    @property
    def capacity(self) -> int:
        return self.num_blocks - 1

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def live_blocks(self) -> int:
        """DISTINCT live blocks — a block with N holders counts once."""
        return len(self._holders)

    def refcount(self, block: int) -> int:
        return len(self._holders.get(block, ()))

    def owned_by(self, rid: int) -> list[int]:
        return sorted(b for b, h in self._holders.items() if rid in h)

    def alloc(self, rid: int, n: int) -> list[int] | None:
        """``n`` fresh blocks for request ``rid``, lowest ids first — or
        None (and no state change) when the pool cannot satisfy it."""
        if n > len(self._free):
            return None
        got = [self._free.pop() for _ in range(n)]
        for b in got:
            self._holders[b] = {rid}
        return got

    def share(self, rid: int, blocks: list[int]) -> None:
        """Ref-bump live ``blocks`` for holder ``rid`` (the COW claim: a
        new request adopts a cached prefix without copying anything —
        the first write it would need into a shared block never happens,
        because the scheduler only shares FULL prompt blocks and routes
        every later write into privately allocated blocks)."""
        for b in blocks:
            holders = self._holders.get(b)
            if holders is None:
                raise ValueError(
                    f"request {rid} sharing dead block {b}")
            if rid in holders:
                raise ValueError(
                    f"request {rid} already holds block {b}")
        for b in blocks:
            self._holders[b].add(rid)

    def free(self, rid: int, blocks: list[int]) -> None:
        """Drop ``rid``'s hold on ``blocks``; a block is recycled only
        when its last holder lets go (refcount 0)."""
        for b in blocks:
            if rid not in self._holders.get(b, ()):
                raise ValueError(
                    f"request {rid} freeing block {b} it does not own "
                    f"(holders: {sorted(self._holders.get(b, ()))})")
        released = False
        for b in blocks:
            holders = self._holders[b]
            holders.discard(rid)
            if not holders:
                del self._holders[b]
                self._free.append(b)
                released = True
                if self.on_recycle is not None:
                    self.on_recycle(b)
        if released:
            self._free.sort(reverse=True)

    def stats(self) -> dict:
        """Occupancy snapshot for the metrics plane
        (``obs.metrics.absorb_pool``) — pure reads, no state change."""
        shared = sum(1 for h in self._holders.values() if len(h) > 1)
        return {
            "capacity": self.capacity,
            "free": len(self._free),
            "live": len(self._holders),
            "shared": shared,
            "holds": sum(len(h) for h in self._holders.values()),
        }

    def check_leaks(self) -> None:
        """Every block accounted for exactly once (the accounting test):
        free + distinct-live == capacity, nothing both free and live,
        and no live block with an empty holder set (a refcount leak)."""
        if len(self._free) + len(self._holders) != self.capacity:
            raise AssertionError(
                f"block leak: {len(self._free)} free + "
                f"{len(self._holders)} owned != {self.capacity}")
        if set(self._free) & set(self._holders):
            raise AssertionError("block aliased free AND owned")
        empty = [b for b, h in self._holders.items() if not h]
        if empty:
            raise AssertionError(
                f"refcount leak: live blocks with no holder: {empty}")


@dataclasses.dataclass
class BlockStore:
    """Host-RAM spill tier under the device :class:`BlockPool`.

    Where the pool hands out *ids into a device buffer*, the store holds
    the *payload itself*: one entry per spilled block, a list of numpy
    rows (one per cache-collection leaf — k, v, and the int8 scale rows
    when quantized) captured by a d2h copy at demotion time.  Holder
    semantics deliberately mirror the pool's refcounted ledger —
    :meth:`put` creates a block with one holder, :meth:`share` ref-bumps
    it for another (a COW-shared device block spills ONCE and its host
    copy is shared the same way), :meth:`free` drops a hold and deletes
    the payload at refcount 0 — so :meth:`check_leaks` can audit the two
    tiers with the same discipline.

    ``capacity`` bounds the number of live host blocks (``None`` =
    unbounded: host RAM is the big tier); a full store makes :meth:`put`
    return ``None`` and the caller falls back to the destructive path
    (re-prefill), never a wrong token.  Host ids are monotonically
    increasing and never recycled, which keeps every (id -> content)
    association unambiguous across a run.
    """

    capacity: int | None = None

    def __post_init__(self) -> None:
        if self.capacity is not None and self.capacity < 1:
            raise ValueError("BlockStore capacity must be >= 1 or None")
        self._next = 0
        self._payloads: dict[int, list[np.ndarray]] = {}
        self._holders: dict[int, set[int]] = {}

    def live_blocks(self) -> int:
        return len(self._payloads)

    def refcount(self, block: int) -> int:
        return len(self._holders.get(block, ()))

    def owned_by(self, rid: int) -> list[int]:
        return sorted(b for b, h in self._holders.items() if rid in h)

    def put(self, rid: int, payload: list[np.ndarray]) -> int | None:
        """Store one spilled block for holder ``rid``; returns the host
        block id, or None (no state change) when the store is full."""
        if self.capacity is not None and len(self._payloads) >= self.capacity:
            return None
        h = self._next
        self._next += 1
        self._payloads[h] = payload
        self._holders[h] = {rid}
        return h

    def get(self, block: int) -> list[np.ndarray]:
        payload = self._payloads.get(block)
        if payload is None:
            raise ValueError(f"reading dead host block {block}")
        return payload

    def share(self, rid: int, blocks: list[int]) -> None:
        """Ref-bump live host ``blocks`` for holder ``rid`` — the spill
        analogue of :meth:`BlockPool.share` (same validation)."""
        for b in blocks:
            holders = self._holders.get(b)
            if holders is None:
                raise ValueError(
                    f"request {rid} sharing dead host block {b}")
            if rid in holders:
                raise ValueError(
                    f"request {rid} already holds host block {b}")
        for b in blocks:
            self._holders[b].add(rid)

    def free(self, rid: int, blocks: list[int]) -> None:
        """Drop ``rid``'s hold; payload deleted at refcount 0."""
        for b in blocks:
            if rid not in self._holders.get(b, ()):
                raise ValueError(
                    f"request {rid} freeing host block {b} it does not "
                    f"own (holders: {sorted(self._holders.get(b, ()))})")
        for b in blocks:
            holders = self._holders[b]
            holders.discard(rid)
            if not holders:
                del self._holders[b]
                del self._payloads[b]

    def bytes_stored(self) -> int:
        return sum(sum(int(a.nbytes) for a in p)
                   for p in self._payloads.values())

    def stats(self) -> dict:
        """Occupancy snapshot for the metrics plane
        (``obs.metrics.absorb_spill_store``) — pure reads."""
        shared = sum(1 for h in self._holders.values() if len(h) > 1)
        return {
            "live": len(self._payloads),
            "shared": shared,
            "holds": sum(len(h) for h in self._holders.values()),
            "bytes": self.bytes_stored(),
        }

    def check_leaks(self) -> None:
        """Every payload has a holder set and vice versa, and no live
        host block has an empty holder set (a refcount leak)."""
        if set(self._payloads) != set(self._holders):
            raise AssertionError(
                f"host tier leak: payloads {sorted(self._payloads)} != "
                f"holders {sorted(self._holders)}")
        empty = [b for b, h in self._holders.items() if not h]
        if empty:
            raise AssertionError(
                f"host refcount leak: blocks with no holder: {empty}")


def blocks_for(tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``tokens`` cache slots."""
    return -(-tokens // block_size)


def table_row(blocks: list[int], blocks_per_seq: int,
              trash: int) -> np.ndarray:
    """A request's table row: its physical blocks in logical order, the
    unallocated tail pointing at the trash block."""
    row = np.full((blocks_per_seq,), trash, np.int32)
    row[:len(blocks)] = np.asarray(blocks, np.int32)
    return row


def kv_block_bytes(cfg, block_size: int) -> int:
    """Bytes one pool block occupies as a host payload (the spill tier's
    and a migration's unit): per layer the K and V rows, ``(H,
    block_size, hd)`` each at the cache dtype, plus for an int8 cache
    the two f32 scale rows ``(H, 1, block_size)``. At GPT-2 124M with
    block size 16 a bf16 block is 12 x 2 x 12 x 16 x 64 x 2 = 589,824
    bytes."""
    item = torch.empty((), dtype=cfg.cache_dtype).element_size()
    rows = 2 * cfg.num_heads * block_size * cfg.head_dim * item
    if cfg.kv_dtype == "int8":
        rows += 2 * cfg.num_heads * block_size * 4
    return cfg.num_layers * rows


def kv_migration_bytes(n_blocks: int, cfg, block_size: int) -> int:
    """Bytes a migration of ``n_blocks`` written blocks moves."""
    return n_blocks * kv_block_bytes(cfg, block_size)
