"""Paged KV-cache bookkeeping: fixed-size block pool, per-slot block
tables, content-hash prefix sharing, copy-on-write, and LRU reuse.

(The port's own copy of the JAX package's numpy-only ``cache/paged.py``,
unchanged in behaviour, so both engines build identical block tables.)

This is the HOST side of the paged-cache subsystem.  The device side is a
pool of physical KV pages per attention layer
(``transformer.make_paged_cache``: ``(num_groups, num_blocks, page_size,
kv_heads, head_dim)``) addressed through a per-slot **block table** — so a
slot's KV memory is ``ceil(live_tokens / page_size)`` blocks instead of a
dense ``max_seq`` reservation, and the number of decode slots is bounded by
*live* tokens, not worst-case sequence length (the KV-memory lever both
FPGA serving studies in PAPERS.md identify as dominant).

Sharing model (vLLM-style, full-block granularity plus a partial tail):

  * every FULL block is identified by the **chain hash** of the token
    sequence from position 0 through its last token.  On admission the
    prompt's full blocks are matched against the registry longest-prefix
    first; hits are mapped into the slot's table with a refcount bump —
    the physical block is shared, its page write is skipped.
  * the first unmatched *partial* tail (prompt tokens that only fill part
    of a block) can share a registered block whose tokens *start with*
    the remaining prompt — the slot attends the shared rows under its own
    length mask.  The first decode write into such a block diverges from
    the registered content, so it **copy-on-writes**: a fresh block is
    allocated, the page is copied on device, and the table repoints.
  * registered blocks are immutable; a block is writable in place only
    while it is unregistered and referenced by exactly one slot (a slot's
    own growing tail).  Blocks register when their content is actually on
    device: prompt blocks at scatter-commit, decode blocks when the
    running token chain fills them.
  * a fully-released registered block is not freed — it parks in an LRU
    so a future prompt with the same prefix can re-admit it; the LRU is
    evicted (unregister + free) only when the pool runs dry.

Beyond memory sharing, the LRU-parked registry is a cross-request
**compute cache**: an admission whose prefix blocks hit the registry can
skip their prefill entirely (``reuse_compute=True`` reports
``AdmitPlan.reused_tokens`` — the engine prefills only the unmatched
suffix, attending the shared pages through the block table).  The
``prefill_compute_hits`` / ``reused_prefill_tokens`` counters track how
much prefill work the registry saved.

Everything here is plain numpy/python (no torch): the manager runs in the
engine's host loop and only *describes* device work (which pages the
prefill may write — ``AdmitPlan.write_table`` — and which to copy on
divergence, executed by ``transformer.copy_cache_pages``).  Prompt K/V
streams straight into the pool as the prefill runs; there is no dense
staging buffer and no commit-time copy.
"""
from __future__ import annotations

from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

_ROOT = ("kv-chain-root",)   # parent "hash" of the first block


def _chain_hash(parent, tokens) -> int:
    return hash((parent, tuple(int(t) for t in tokens)))


class PoolExhausted(RuntimeError):
    """The block pool has no free or evictable block left."""


class ConcurrentPeakTracker:
    """Concurrent peak of blocks-in-use ACROSS a set of pools.

    Per-pool ``peak_in_use`` maxima occur at different times, so summing
    them overstates the true concurrent footprint (and understates the
    effective-slots gain derived from it).  Pools attached here ping the
    tracker on every allocate/retain; the tracker records the maximum of
    the *summed instantaneous* usage instead."""

    def __init__(self):
        self.pools: List[BlockPool] = []
        self.peak = 0

    def attach(self, pool: "BlockPool"):
        # Idempotent: re-planning re-attaches the surviving pools of the
        # new replica layout to the engine-lifetime tracker; a pool that
        # is already tracked must not be appended again (it would be
        # summed twice in every subsequent ``note`` and inflate the peak).
        if pool not in self.pools:
            self.pools.append(pool)
        pool.tracker = self
        self.note()

    def note(self):
        now = sum(p.blocks_in_use for p in self.pools)
        if now > self.peak:
            self.peak = now

    def reset(self):
        self.peak = sum(p.blocks_in_use for p in self.pools)


class BlockPool:
    """Fixed-size pool of physical KV blocks with refcounts, a content
    registry (chain hash -> block) for prefix sharing, and an LRU of
    fully-released registered blocks kept warm for reuse."""

    def __init__(self, num_blocks: int, page_size: int):
        if num_blocks < 1 or page_size < 1:
            raise ValueError(f"need >= 1 block and page ({num_blocks}, "
                             f"{page_size})")
        self.num_blocks = num_blocks
        self.page_size = page_size
        self.refcount = np.zeros((num_blocks,), np.int32)
        self.free: deque = deque(range(num_blocks))
        self.registry: Dict[int, int] = {}          # chain hash -> block
        self.hash_of: Dict[int, int] = {}           # block -> chain hash
        self.parent_of: Dict[int, object] = {}      # block -> parent hash
        self.tokens_of: Dict[int, np.ndarray] = {}  # block -> its tokens
        self.children: Dict[object, List[int]] = {}  # parent -> blocks
        self.lru: "OrderedDict[int, None]" = OrderedDict()  # ref 0, registered
        self.tracker: Optional[ConcurrentPeakTracker] = None
        # stats ------------------------------------------------------------
        self.prefix_queries = 0
        self.prefix_hits = 0
        self.cow_copies = 0
        self.evictions = 0
        self.peak_in_use = 0
        # prefill compute-cache accounting (suffix-only prefill) -----------
        self.prefill_admissions = 0
        self.prefill_compute_hits = 0     # admissions that skipped compute
        self.reused_prefill_tokens = 0    # prompt tokens NOT re-prefilled
        self.suffix_prefill_tokens = 0    # prompt tokens actually computed

    # -- capacity ----------------------------------------------------------
    @property
    def blocks_in_use(self) -> int:
        """Blocks referenced by at least one slot."""
        return int(np.sum(self.refcount > 0))

    @property
    def blocks_cached(self) -> int:
        """Fully-released registered blocks parked for prefix reuse."""
        return len(self.lru)

    @property
    def blocks_free(self) -> int:
        return len(self.free)

    def available(self, excluding=()) -> int:
        """Blocks an allocation burst can obtain right now (free + LRU-
        evictable), optionally not counting blocks about to be retained."""
        ex = sum(1 for b in excluding if b in self.lru)
        return len(self.free) + len(self.lru) - ex

    # -- alloc / refcount --------------------------------------------------
    def allocate(self) -> int:
        """A fresh exclusively-owned block (refcount 1), evicting the
        least-recently-released cached block if the free list is empty."""
        if self.free:
            blk = self.free.popleft()
        elif self.lru:
            blk, _ = self.lru.popitem(last=False)   # oldest release first
            self._unregister(blk)
            self.evictions += 1
        else:
            raise PoolExhausted(
                f"block pool exhausted ({self.num_blocks} blocks of "
                f"{self.page_size} tokens all referenced); size the pool "
                f"with num_blocks >= slots * max_seq / page_size to rule "
                f"this out, or retire requests sooner")
        self.refcount[blk] = 1
        self.peak_in_use = max(self.peak_in_use, self.blocks_in_use)
        if self.tracker is not None:
            self.tracker.note()
        return int(blk)

    def retain(self, blk: int):
        """Add a reference to a (possibly LRU-parked) registered block."""
        self.refcount[blk] += 1
        self.lru.pop(blk, None)
        self.peak_in_use = max(self.peak_in_use, self.blocks_in_use)
        if self.tracker is not None:
            self.tracker.note()

    def release(self, blk: int):
        assert self.refcount[blk] > 0, blk
        self.refcount[blk] -= 1
        if self.refcount[blk] == 0:
            if blk in self.hash_of:
                self.lru[blk] = None                # park, newest at the end
            else:
                self.free.append(blk)

    def writable(self, blk: int) -> bool:
        """In-place writes need exclusive ownership of mutable content:
        exactly one reference AND not registered (registered = immutable,
        other prompts may map it)."""
        return self.refcount[blk] == 1 and blk not in self.hash_of

    # -- registry (content-hash prefix sharing) ----------------------------
    def register(self, blk: int, parent, tokens) -> bool:
        """Publish a FULL block's content under its chain hash.  First
        writer wins: a colliding hash leaves the existing block in place
        and this one unregistered (still exclusively owned, still valid)."""
        h = _chain_hash(parent, tokens)
        if h in self.registry:
            return False
        self.registry[h] = blk
        self.hash_of[blk] = h
        self.parent_of[blk] = parent
        self.tokens_of[blk] = np.asarray(tokens, np.int32).copy()
        self.children.setdefault(parent, []).append(blk)
        return True

    def lookup_full(self, parent, tokens) -> Tuple[int, Optional[int]]:
        """(chain hash, registered block or None) for a full block.  A
        hit is confirmed against the stored tokens and parent link, so a
        chain-hash collision is a clean miss rather than silently mapping
        another request's K/V."""
        h = _chain_hash(parent, tokens)
        self.prefix_queries += 1
        blk = self.registry.get(h)
        if blk is not None and (self.parent_of[blk] != parent
                                or not np.array_equal(
                                    self.tokens_of[blk],
                                    np.asarray(tokens, np.int32))):
            blk = None
        if blk is not None:
            self.prefix_hits += 1
        return h, blk

    def lookup_partial(self, parent, tokens) -> Optional[int]:
        """A registered child of ``parent`` whose content *starts with*
        ``tokens`` (the shared-partial-tail case; the extra rows are
        masked by the sharer's length until copy-on-write)."""
        self.prefix_queries += 1
        want = np.asarray(tokens, np.int32)
        for blk in self.children.get(parent, ()):
            if np.array_equal(self.tokens_of[blk][:len(want)], want):
                self.prefix_hits += 1
                return blk
        return None

    def _unregister(self, blk: int):
        h = self.hash_of.pop(blk, None)
        if h is None:
            return
        del self.registry[h]
        parent = self.parent_of.pop(blk)
        self.tokens_of.pop(blk, None)
        kids = self.children.get(parent)
        if kids is not None:
            kids.remove(blk)
            if not kids:
                del self.children[parent]


@dataclass
class BlockTable:
    """One slot's logical-to-physical block map plus its token chain (the
    chain is what names blocks for registration and prefix matching)."""
    blocks: np.ndarray                    # (max_blocks,) int32, sentinel = -1
    chain: List[int] = field(default_factory=list)   # tokens written so far
    hashes: List[int] = field(default_factory=list)  # chain hash per full blk
    reserved: int = 0                     # growth blocks reserved, not drawn

    @property
    def n_mapped(self) -> int:
        return int(np.sum(self.blocks >= 0))


@dataclass
class AdmitPlan:
    """Device work an admission implies: which logical prompt blocks the
    prefill may write (the rest are shared and already populated), the
    gather table it attends through, and how much prefill compute the
    registry saved."""
    slot: int
    shared_blocks: Tuple[int, ...]        # physical ids mapped without write
    write_logical: np.ndarray             # (max_blocks,) padded logical idx
    write_phys: np.ndarray                # (max_blocks,) padded; pad = pool
    #                                       size (dropped by the scatter)
    n_write: int
    block_table: np.ndarray               # (max_blocks,) gather table over
    #                                       ALL mapped blocks; sentinel =
    #                                       pool size for unmapped entries
    write_table: np.ndarray               # (max_blocks,) fresh block phys id
    #                                       at its logical position; shared /
    #                                       unmapped entries carry the
    #                                       sentinel so prefill writes drop
    reused_tokens: int = 0                # prefix tokens whose prefill is
    #                                       skipped (warm compute-cache hit);
    #                                       the suffix starts here


class PagedCacheManager:
    """Block-table bookkeeping for one engine (or one decode replica).

    Slots index rows of the block-table matrix; the engine calls, in
    order: ``admit`` (map + allocate at admission), ``commit`` (after the
    prompt scatter lands — publishes the slot's full blocks for sharing),
    ``prepare_decode`` (before each decode write — allocates the next
    block at a page boundary, copy-on-writes a shared/immutable one),
    ``note_written`` (after each decode step — extends the token chain,
    registers blocks as they fill), and ``release_slot`` at retirement.
    """

    def __init__(self, slots: int, max_seq: int, page_size: int,
                 num_blocks: int, *, prefix_cache: bool = True,
                 kv_dtype: str = "fp", kv_capacity_ratio: float = 1.0):
        if max_seq % page_size:
            raise ValueError(
                f"max_seq={max_seq} must be a multiple of "
                f"page_size={page_size} (block tables tile the sequence)")
        if kv_dtype not in ("fp", "int8"):
            raise ValueError(f"kv_dtype={kv_dtype!r} must be 'fp' or 'int8'")
        self.slots = slots
        self.max_seq = max_seq
        self.page_size = page_size
        self.blocks_per_slot = max_seq // page_size
        self.prefix_cache = prefix_cache  # False: no registry lookups, no
        #                                   registration, no LRU parking
        # storage dtype of the device pool this manager fronts ("int8":
        # quantized rows + per-row scales) and the tokens-per-byte
        # multiplier over the fp layout it buys
        # (``transformer.paged_kv_capacity_ratio``)
        self.kv_dtype = kv_dtype
        self.kv_capacity_ratio = (1.0 if kv_dtype == "fp"
                                  else float(kv_capacity_ratio))
        self.pool = BlockPool(num_blocks, page_size)
        self.tables = [BlockTable(np.full((self.blocks_per_slot,), -1,
                                          np.int32))
                       for _ in range(slots)]
        self._pending: Dict[int, List[Tuple[int, int, object,
                                            np.ndarray]]] = {}
        self._pending_map: Dict[int, np.ndarray] = {}
        self._reserved = 0                # sum of per-slot growth reserves
        self.migrations = 0               # zero-copy slot handoffs served

    # -- views -------------------------------------------------------------
    def table_matrix(self) -> np.ndarray:
        """(slots, max_blocks) int32 for the decode step; unmapped entries
        carry ``num_blocks`` (one past the pool: gathers clip to a masked
        garbage page, scatters drop)."""
        out = np.stack([t.blocks for t in self.tables])
        out[out < 0] = self.pool.num_blocks
        return out

    # -- admission ---------------------------------------------------------
    def admit(self, slot: int, prompt, max_new_tokens: int = 0, *,
              reuse_compute: bool = False) -> Optional[AdmitPlan]:
        """Map the prompt onto blocks: longest-prefix match of full blocks
        against the registry, optional partial-tail share, fresh blocks
        for the rest — plus a *reservation* for the request's worst-case
        decode growth (``max_new_tokens``), drawn down as the blocks are
        actually allocated.  Returns None (no state change) when the pool
        cannot supply prompt + growth — the engine defers the admission.
        Raises PoolExhausted when the request could NEVER fit the pool.

        ``reuse_compute=True`` additionally reports the matched prefix as
        ``AdmitPlan.reused_tokens`` so the engine prefills only the
        unmatched suffix (always at least one token: the last prompt
        position is recomputed to produce the first-token logits).  Leave
        it False for families whose prefill is not suffix-decomposable
        (see ``transformer.supports_prefix_compute_reuse``) — blocks
        still share their *memory* either way."""
        P = self.page_size
        prompt = np.asarray(prompt, np.int32)
        L = len(prompt)
        assert 0 < L <= self.max_seq, (L, self.max_seq)
        n_full, rem = divmod(L, P)
        # a deferred admission is retried every tick: snapshot the reuse
        # counters so only the attempt that actually admits counts (the
        # reported hit rate is per logical admission, not per retry)
        q0, h0 = self.pool.prefix_queries, self.pool.prefix_hits

        shared: List[int] = []
        hashes: List[int] = []
        h = _ROOT
        if self.prefix_cache:
            for j in range(n_full):
                h2, blk = self.pool.lookup_full(h, prompt[j * P:(j + 1) * P])
                if blk is None:
                    break
                shared.append(blk)
                hashes.append(h2)
                h = h2
        m = len(shared)
        tail_shared = None
        if self.prefix_cache and m == n_full and rem:
            tail_shared = self.pool.lookup_partial(h, prompt[n_full * P:])

        retained = shared + ([tail_shared] if tail_shared is not None
                             else [])
        n_new = (n_full - m) + (1 if rem and tail_shared is None else 0)
        # worst-case decode growth: blocks beyond the prompt's own up to
        # the token budget (or the slot cap), plus the copy-on-write
        # replacement a shared tail will need on its first divergent
        # write.  Reserving it up front is what lets a pool smaller than
        # the dense reservation DEFER admissions instead of raising
        # PoolExhausted mid-stream.
        total_blocks = -(-min(L + max(max_new_tokens, 0), self.max_seq)
                         // P)
        growth = (total_blocks - n_full - (1 if rem else 0)
                  + (1 if tail_shared is not None else 0))
        # feasibility counts the retained shared blocks too: they occupy
        # pool capacity the fresh allocations can never reclaim, so a
        # request whose shared + fresh footprint exceeds the pool must
        # raise (deferring would livelock the FIFO head forever)
        if len(retained) + n_new + growth > self.pool.num_blocks:
            # the raise is still "no admission happened": restore the
            # reuse counters just like the deferral path below, or a
            # never-fits request would permanently skew reuse_hit_rate
            self.pool.prefix_queries, self.pool.prefix_hits = q0, h0
            raise PoolExhausted(
                f"a {L}-token prompt with max_new_tokens="
                f"{max_new_tokens} needs {len(retained) + n_new + growth} "
                f"blocks ({len(retained)} shared + {n_new + growth} "
                f"fresh) but the pool only has {self.pool.num_blocks}; "
                f"raise num_blocks or page_size")
        if (self.pool.available(excluding=retained) - self._reserved
                < n_new + growth):
            self.pool.prefix_queries, self.pool.prefix_hits = q0, h0
            return None

        for blk in retained:
            self.pool.retain(blk)
        tb = self.tables[slot]
        assert tb.n_mapped == 0, f"slot {slot} still mapped"
        # the table row is NOT written here: a reserved slot must ride
        # decode ticks with an unmapped (sentinel) row so its stale-
        # position write drops — the mapping lands at commit(), together
        # with the prefill writes that make the fresh blocks' content real.
        mapped = np.full((self.blocks_per_slot,), -1, np.int32)
        tb.chain = [int(t) for t in prompt]
        tb.hashes = list(hashes)
        for j, blk in enumerate(shared):
            mapped[j] = blk
        write_log, write_phys = [], []
        pending: List[Tuple[int, int, object, np.ndarray]] = []
        for j in range(m, n_full):
            blk = self.pool.allocate()
            mapped[j] = blk
            write_log.append(j)
            write_phys.append(blk)
            toks = prompt[j * P:(j + 1) * P]
            h = _chain_hash(h, toks)
            tb.hashes.append(h)
            pending.append((j, blk, tb.hashes[j - 1] if j else _ROOT, toks))
        if rem:
            if tail_shared is not None:
                mapped[n_full] = tail_shared
            else:
                blk = self.pool.allocate()
                mapped[n_full] = blk
                write_log.append(n_full)
                write_phys.append(blk)
        self._pending[slot] = pending
        self._pending_map[slot] = mapped
        tb.reserved = growth
        self._reserved += growth

        # compute-cache accounting: the matched prefix's prefill is
        # skipped outright (the suffix keeps at least the last prompt
        # token — its hidden state is what produces the first logits)
        matched = m * P + (rem if tail_shared is not None else 0)
        reused = min(matched, L - 1) if reuse_compute else 0
        self.pool.prefill_admissions += 1
        if reused > 0:
            self.pool.prefill_compute_hits += 1
        self.pool.reused_prefill_tokens += reused
        self.pool.suffix_prefill_tokens += L - reused

        MB, NB = self.blocks_per_slot, self.pool.num_blocks
        logical = np.zeros((MB,), np.int32)
        phys = np.full((MB,), NB, np.int32)          # pad = dropped write
        logical[:len(write_log)] = write_log
        phys[:len(write_phys)] = write_phys
        gather = mapped.copy()
        gather[gather < 0] = NB                      # sentinel: masked page
        wtable = np.full((MB,), NB, np.int32)        # sentinel: dropped write
        for j, blk in zip(write_log, write_phys):
            wtable[j] = blk
        return AdmitPlan(slot=slot,
                         shared_blocks=tuple(shared) + (
                             (tail_shared,) if tail_shared is not None
                             else ()),
                         write_logical=logical, write_phys=phys,
                         n_write=len(write_log),
                         block_table=gather, write_table=wtable,
                         reused_tokens=int(reused))

    def commit_chunk(self, slot: int, tokens_on_device: int):
        """A prefill chunk's page writes have landed: publish every
        pending FULL block the chunk completed (its content is real on
        device now) without waiting for the whole prompt.  This is what
        makes chunked prefill feed the compute cache incrementally — a
        later admission can hit blocks of a prompt still mid-prefill.
        The table-row mapping itself stays deferred to ``commit`` (a
        reserved slot riding decode must keep an unmapped row)."""
        if not self.prefix_cache:
            return
        pending = self._pending.get(slot)
        if not pending:
            return
        keep, done = [], []
        for e in pending:
            (done if (e[0] + 1) * self.page_size <= tokens_on_device
             else keep).append(e)
        if done:
            self._pending[slot] = keep
            for _, blk, parent, toks in done:
                self.pool.register(blk, parent, toks)

    def commit(self, slot: int):
        """The prefill's page writes have all landed: map the slot's
        table row and publish its remaining freshly written FULL prompt
        blocks for prefix sharing.  (Both deferred until the pages
        actually hold the K/V — a concurrently-admitted prompt must never
        map a still-garbage block, and a reserved slot riding decode must
        keep an unmapped row so its stale-position write drops.)"""
        self.tables[slot].blocks[:] = self._pending_map.pop(slot)
        for _, blk, parent, toks in self._pending.pop(slot, ()):
            if self.prefix_cache:
                self.pool.register(blk, parent, toks)

    # -- decode ------------------------------------------------------------
    def _allocate_reserved(self, tb: BlockTable) -> int:
        """Draw a decode-growth block against the slot's admission-time
        reservation (the reservation is what guarantees this allocation
        cannot raise under the admission gate)."""
        blk = self.pool.allocate()
        if tb.reserved > 0:
            tb.reserved -= 1
            self._reserved -= 1
        return blk

    def prepare_decode(self, slot: int, pos: int
                       ) -> Optional[Tuple[int, int]]:
        """Make the block holding position ``pos`` writable before the
        decode step writes it.  Allocates at a fresh page boundary;
        copy-on-writes a shared or registered block (first divergent
        write).  Returns a ``(src, dst)`` physical pair when the engine
        must copy the page on device, else None."""
        tb = self.tables[slot]
        j = pos // self.page_size
        assert j < self.blocks_per_slot, (pos, self.max_seq)
        blk = int(tb.blocks[j])
        if blk < 0:
            tb.blocks[j] = self._allocate_reserved(tb)
            return None
        if self.pool.writable(blk):
            return None
        new = self._allocate_reserved(tb)
        self.pool.release(blk)
        tb.blocks[j] = new
        self.pool.cow_copies += 1
        return (blk, new)

    def note_written(self, slot: int, token: int, pos: int):
        """A decode step wrote ``token``'s K/V at ``pos``: extend the
        chain; when the write fills its block, register the block (its
        content is now complete and on device)."""
        tb = self.tables[slot]
        assert len(tb.chain) == pos, (len(tb.chain), pos)
        tb.chain.append(int(token))
        P = self.page_size
        if (pos + 1) % P == 0:
            j = pos // P
            parent = tb.hashes[j - 1] if j else _ROOT
            toks = np.asarray(tb.chain[j * P:(j + 1) * P], np.int32)
            tb.hashes.append(_chain_hash(parent, toks))
            blk = int(tb.blocks[j])
            if self.prefix_cache and self.pool.writable(blk):
                self.pool.register(blk, parent, toks)  # exclusively ours

    def rollback(self, slot: int, pos: int):
        """Rewind the slot to ``pos`` written tokens: truncate the chain
        (and the per-block hash spine), release blocks wholly past the
        accepted position, and return them to the slot's growth
        reservation.  This is the reject path of speculative decode —
        only ever invoked on positions the slot itself just wrote, so
        every released block is a fresh exclusively-owned decode block
        (never shared, never registered: blocks register only when FULL,
        and a full block at index < ceil(pos/P) is always kept)."""
        tb = self.tables[slot]
        P = self.page_size
        n_keep = -(-pos // P)
        for j in range(n_keep, self.blocks_per_slot):
            blk = int(tb.blocks[j])
            if blk < 0:
                continue
            assert self.pool.writable(blk), (slot, j, blk)
            self.pool.release(blk)
            tb.blocks[j] = -1
            tb.reserved += 1
            self._reserved += 1
        del tb.chain[pos:]
        del tb.hashes[pos // P:]

    # -- migration ---------------------------------------------------------
    def migrate_slot(self, src: int, dst: int):
        """Hand a slot's entire paged state to another slot row: block
        table, token chain, per-block hash spine, and growth reservation
        move wholesale.  ZERO device work and zero net refcount traffic —
        the physical pool is shared, no block moves, and the number of
        references per block is unchanged (each reference merely changes
        which table row holds it).  This is the primitive behind
        cross-replica work stealing and traffic-adaptive re-planning
        (``ServingEngine.replan``): on the paged path a request IS its
        block-table row, so migration is pure host bookkeeping.

        ``src`` must be committed (the engine never migrates a slot whose
        chunked prefill is still streaming — its mapping is pending) and
        ``dst`` must be empty."""
        if src == dst:
            return
        assert src not in self._pending and src not in self._pending_map, \
            f"slot {src} is mid-prefill (mapping pending commit)"
        assert dst not in self._pending and dst not in self._pending_map, \
            f"slot {dst} has a pending admission"
        s, d = self.tables[src], self.tables[dst]
        assert d.n_mapped == 0 and not d.chain and d.reserved == 0, \
            f"destination slot {dst} is not empty"
        d.blocks[:] = s.blocks
        d.chain, d.hashes, d.reserved = s.chain, s.hashes, s.reserved
        s.blocks[:] = -1
        s.chain, s.hashes, s.reserved = [], [], 0
        self.migrations += 1

    # -- retirement --------------------------------------------------------
    def release_slot(self, slot: int):
        tb = self.tables[slot]
        # an uncommitted admission keeps its mapping in _pending_map (the
        # table row stays sentinel until commit) — release whichever holds
        # the slot's references
        mapped = self._pending_map.pop(slot, tb.blocks)
        for blk in mapped:
            if blk >= 0:
                self.pool.release(int(blk))
        tb.blocks[:] = -1
        tb.chain = []
        tb.hashes = []
        self._reserved -= tb.reserved     # unused growth returns to the pool
        tb.reserved = 0
        self._pending.pop(slot, None)

    # -- stats -------------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        p = self.pool
        return {
            "page_size": self.page_size,
            "num_blocks": p.num_blocks,
            "blocks_in_use": p.blocks_in_use,
            "blocks_cached": p.blocks_cached,
            "blocks_free": p.blocks_free,
            "peak_blocks_in_use": p.peak_in_use,
            "prefix_queries": p.prefix_queries,
            "prefix_hits": p.prefix_hits,
            "reuse_hit_rate": p.prefix_hits / max(p.prefix_queries, 1),
            "cow_copies": p.cow_copies,
            "evictions": p.evictions,
            "migrations": self.migrations,
            "prefix_cache": self.prefix_cache,
            "prefill_admissions": p.prefill_admissions,
            "prefill_compute_hits": p.prefill_compute_hits,
            "prefill_hit_rate": (p.prefill_compute_hits
                                 / max(p.prefill_admissions, 1)),
            "reused_prefill_tokens": p.reused_prefill_tokens,
            "suffix_prefill_tokens": p.suffix_prefill_tokens,
            "kv_dtype": self.kv_dtype,
            "kv_capacity_x": self.kv_capacity_ratio,
        }
