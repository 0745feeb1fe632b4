"""Two-tier (HBM + DRAM) paged KV block table with eager block rotation and
a content-addressed, ref-counted prefix cache.

Block life-cycle (paper §4.3.2):

  HBM_DIRTY  --block fills up-->  HBM_SYNCED(no DRAM copy)
  HBM_SYNCED --eager D2H (background)--> BOTH (valid copies in HBM and DRAM)
  preemption: BOTH  -> DRAM_ONLY  (HBM copy dropped, FREE — zero transfer)
              DIRTY/SYNCED -> D2H transfer of just those blocks
  swap-in:    DRAM_ONLY -> BOTH via H2D (DRAM copy retained; a re-preemption
              of an untouched block is again free — eager rotation doubles as
              an incremental host-side backup, used for fault tolerance)

Prefix cache (extension beyond the paper, see DESIGN.md §Two-tier prefix
cache): blocks are reference-counted (``Block.ref_ids``) instead of
exclusively owned. Full prompt blocks get a chained content hash
``h_i = hash((h_{i-1}, token_ids_of_block_i))``; a hash index maps prefix
hashes to live blocks so a new request with the same prompt prefix increfs
the existing blocks instead of re-prefilling (``match_prefix``). Releasing a
request decrefs; at refcount 0 a content-addressed block is *retained* in an
LRU cache rather than freed. The superchip twist: cold cached HBM blocks are
demoted to the DRAM tier through the eager D2H path (they are ``synced`` and
unreferenced, so ``eager_candidates`` copies them host-side for free), and a
later hit on a DRAM-tier entry swaps the block back in over NVLink-C2C
instead of re-prefilling. Cache lifecycle:

  CACHED_HBM --eager D2H--> CACHED_BOTH --HBM pressure--> CACHED_DRAM
  CACHED_DRAM --prefix hit--> promoted H2D (BOTH, refcount > 0)
  CACHED_DRAM --DRAM pressure--> evicted (slots recycled, hash unindexed)

With ``prefix_cache=False`` (the default) every path below reduces exactly
to the pre-cache behaviour: blocks carry a single reference, releases free
immediately, and no hash/LRU state is touched — replay is bit-identical.

Data-race-freedom invariant (checked): an HBM slot never serves simultaneously
as a swap-in destination and a swap-out source — swap-in/promotion
destinations come from the free pool (or a completed eviction), swap-out
sources are freed only on transfer completion. Cache traffic preserves it:
eviction/demotion only touches refcount-0 blocks with no transfer in flight.
"""
from __future__ import annotations

import collections
import dataclasses
import enum
from typing import Dict, List, Optional, Sequence, Set, Tuple


class BlockLoc(enum.Enum):
    HBM = "hbm"
    DRAM = "dram"
    BOTH = "both"


@dataclasses.dataclass
class Block:
    block_id: int
    index: int                 # position in the (shared) prefix / block list
    loc: BlockLoc
    ref_ids: Set[int] = dataclasses.field(default_factory=set)
    synced: bool = False       # fully written (immutable until released)
    hash: Optional[int] = None  # chained content hash (full prompt blocks)
    last_used: int = 0         # LRU tick (refcount-0 cache ordering)
    hbm_slot: Optional[int] = None
    dram_slot: Optional[int] = None
    d2h_inflight: bool = False
    h2d_inflight: bool = False

    @property
    def ref_count(self) -> int:
        return len(self.ref_ids)


@dataclasses.dataclass(frozen=True)
class TransferDesc:
    """One block move; ``segments`` is the number of contiguous regions the
    layout imposes (layer-first: N_layers segments; block-first: 1)."""
    block_id: int
    req_id: int                # first referencing request, or -1 (cache move)
    direction: str             # "d2h" | "h2d"
    src_slot: int
    dst_slot: int
    nbytes: int
    segments: int


@dataclasses.dataclass(frozen=True)
class ExportedBlockMeta:
    """One block of a request leaving this table in a cross-replica
    migration (serving/disagg.py). ``src_dram_slot`` keys the host payload
    in the *source* store; ``moved`` says whether the source fully freed the
    block (the payload travels zero-copy) or retained it (live sharers or
    cache retention — the payload is handed off by reference)."""
    position: int              # index in the request's block list
    hash: Optional[int]        # chained content hash (full prompt blocks)
    synced: bool
    src_dram_slot: int
    nbytes: int
    moved: bool


@dataclasses.dataclass
class KVView:
    """Per-iteration residency snapshot handed to the scheduler so its block
    accounting shrinks by the cached/shared share (prefix-cache mode only).

    ``resident``   req_id -> HBM-resident blocks already held (WAITING with
                   cache hits, ROTARY whose shared prefix stayed on-device);
    ``releasable`` req_id -> blocks a preemption would actually free
                   (exclusively referenced, HBM-resident).
    """
    resident: Dict[int, int] = dataclasses.field(default_factory=dict)
    releasable: Dict[int, int] = dataclasses.field(default_factory=dict)


class OutOfBlocks(RuntimeError):
    pass


class TwoTierBlockTable:
    def __init__(self, num_hbm_blocks: int, num_dram_blocks: int,
                 block_bytes: int, segments_per_block: int,
                 prefix_cache: bool = False):
        self.block_bytes = block_bytes
        self.segments_per_block = segments_per_block
        self.prefix_cache = prefix_cache
        self._hbm_free: List[int] = list(range(num_hbm_blocks - 1, -1, -1))
        self._dram_free: List[int] = list(range(num_dram_blocks - 1, -1, -1))
        self._blocks: Dict[int, Block] = {}
        self._by_req: Dict[int, List[int]] = {}
        self._next_id = 0
        self.num_hbm_blocks = num_hbm_blocks
        self.num_dram_blocks = num_dram_blocks
        # content-addressed cache state (inert when prefix_cache is False)
        self._hash_index: Dict[int, int] = {}          # prefix hash -> block
        self._cached_lru: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()                  # refcount-0 retained
        # intra-HBM row copies (CoW forks) pending physical execution; only
        # consumed when a data backend is attached (see DuplexKV)
        self.pending_d2d: List[Tuple[int, int]] = []   # (src_slot, dst_slot)
        # Pipelined-execution hazard tracking: HBM slots the CURRENT batch
        # reads/writes (set by the engine before kernels dispatch, cleared
        # after). A slot under an in-flight transfer may not be written by
        # compute, and a slot an in-flight H2D is writing may not be touched
        # by compute at all; read-read (eager D2H under decode reads of the
        # same synced block) is legal — that concurrency is the whole point.
        self.compute_reads: Set[int] = set()
        self.compute_writes: Set[int] = set()
        self._tick = 0
        self._mut = 0                  # bumped on cache-membership mutations
        self._evict_memo: Tuple[int, int] = (-1, 0)    # (mut, evictable)
        # stats
        self.eager_d2h_blocks = 0
        self.preempt_d2h_blocks = 0
        self.preempt_free_blocks = 0
        self.swapin_h2d_blocks = 0
        # cache stats
        self.cache_hit_blocks = 0
        self.cache_hit_tokens = 0
        self.dram_hit_blocks = 0       # hits served by promoting a DRAM entry
        self.cow_blocks = 0            # copy-on-write forks of partial tails
        self.retained_blocks = 0       # releases that entered the cache
        self.demoted_blocks = 0        # cached HBM copies dropped (kept DRAM)
        self.evicted_blocks = 0        # cached blocks fully evicted
        # cross-replica migration stats (serving/disagg.py)
        self.migrate_d2h_blocks = 0    # blocks that needed a fresh D2H
        self.exported_blocks = 0       # blocks handed off to another table
        self.imported_blocks = 0       # blocks adopted from another table
        self.import_shared_blocks = 0  # imports served by an existing hash hit

    # -- capacity -------------------------------------------------------------
    @property
    def hbm_free(self) -> int:
        """Allocatable HBM blocks: the free pool plus refcount-0 cached
        blocks that can be evicted on demand (the budget admission sees)."""
        return len(self._hbm_free) + self._evictable_hbm()

    @property
    def dram_free(self) -> int:
        return len(self._dram_free)

    @property
    def cached_blocks(self) -> int:
        """Refcount-0 blocks currently retained by the prefix cache."""
        return len(self._cached_lru)

    def blocks_of(self, req_id: int) -> List[Block]:
        return [self._blocks[b] for b in self._by_req.get(req_id, [])]

    def hbm_blocks_of(self, req_id: int) -> int:
        return sum(1 for b in self.blocks_of(req_id)
                   if b.loc in (BlockLoc.HBM, BlockLoc.BOTH))

    def releasable_hbm_blocks_of(self, req_id: int) -> int:
        """HBM blocks a preemption of this request would actually free
        (exclusively referenced; shared prefix blocks stay resident)."""
        return sum(1 for b in self.blocks_of(req_id)
                   if b.ref_count == 1
                   and b.loc in (BlockLoc.HBM, BlockLoc.BOTH))

    # -- allocation -----------------------------------------------------------
    def alloc(self, req_id: int, n: int) -> List[Block]:
        """Allocate ``n`` fresh exclusively-referenced blocks (refcount 1),
        evicting cold refcount-0 cache entries if the free pool runs short."""
        evictable = self._evictable_hbm()
        if len(self._hbm_free) + evictable < n:
            raise OutOfBlocks(
                f"need {n} HBM blocks, have {len(self._hbm_free)}"
                + (f" free + {evictable} evictable" if evictable else ""))
        out = []
        lst = self._by_req.setdefault(req_id, [])
        for _ in range(n):
            slot = self._take_hbm_slot()
            if slot is None:       # capacity raced away (should not happen)
                raise OutOfBlocks(f"HBM eviction failed mid-alloc for {req_id}")
            b = Block(self._next_id, len(lst), BlockLoc.HBM,
                      ref_ids={req_id}, hbm_slot=slot)
            self._next_id += 1
            self._blocks[b.block_id] = b
            lst.append(b.block_id)
            out.append(b)
        return out

    def mark_synced(self, req_id: int, upto_index: int) -> None:
        """Blocks [0, upto_index) of the request are fully written."""
        for bid in self._by_req.get(req_id, [])[:upto_index]:
            self._blocks[bid].synced = True

    def drain_pending_d2d(self) -> List[Tuple[int, int]]:
        out, self.pending_d2d = self.pending_d2d, []
        return out

    def invalidate_dirty_tail(self, req_id: int, from_block: int) -> None:
        """Drop the DRAM copy of every block index >= ``from_block`` — the
        first block THIS iteration's writes touched. Physical-data mode only
        (DuplexKV gates on its data backend): a dirty block swapped out and
        back in is BOTH with ``synced=True`` (``complete_swap_out``'s
        approximation), so a later preemption would free its HBM copy
        transfer-less — against a host copy that predates the tokens
        written since the swap-in. Starting at the *written* block (not the
        full-block watermark) matters: a write that completes a block, or a
        resumed prefill chunk filling a previously-partial block, leaves it
        below the watermark yet host-stale. Invalidated blocks re-enter the
        eager D2H path once (re)synced. The sim path keeps the cheap
        approximation (timing-only, golden-pinned)."""
        for i, bid in enumerate(self._by_req.get(req_id, [])):
            if i < from_block:
                continue
            b = self._blocks[bid]
            if (b.loc == BlockLoc.BOTH and not b.d2h_inflight
                    and not b.h2d_inflight):
                self._dram_free.append(b.dram_slot)
                b.dram_slot = None
                b.loc = BlockLoc.HBM
                b.synced = False
                self._mut += 1

    # -- content-addressed prefix cache ---------------------------------------
    def match_prefix(self, req_id: int, chain: Sequence[int],
                     max_tokens: int, block_size: int
                     ) -> Tuple[int, List[TransferDesc]]:
        """Lookup-then-incref: walk the chained prefix hashes, sharing each
        hit block with ``req_id``. DRAM-tier hits are promoted (H2D
        descriptors returned for the caller to execute); a hit whose tail the
        request will overwrite is forked copy-on-write. Returns
        ``(cached_tokens, promotion_descs)``; stops at the first miss."""
        if not self.prefix_cache or req_id in self._by_req:
            return 0, []
        promos: List[TransferDesc] = []
        cached_tokens = 0
        for i, h in enumerate(chain):
            bid = self._hash_index.get(h)
            if bid is None:
                break
            b = self._blocks.get(bid)
            if b is None or not b.synced:
                break
            if (i + 1) * block_size > max_tokens:
                # the request overwrites this block's tail (its prompt ends
                # exactly on a block boundary and the last prompt token must
                # be recomputed for first-token logits): copy-on-write
                nb = self._cow_block(req_id, b, index=i)
                if nb is None:
                    break
                cached_tokens = max_tokens
                self.cow_blocks += 1
                self.cache_hit_blocks += 1
                break
            if b.loc == BlockLoc.DRAM and not b.h2d_inflight:
                # DRAM-tier hit: swap the cached block back in over the
                # NVLink-C2C link instead of re-prefilling it. The eviction
                # that funds the promotion must not consume any block of
                # this chain's own remaining prefix.
                own = {self._hash_index[g] for g in chain[i:]
                       if g in self._hash_index}
                slot = self._take_hbm_slot(exclude=own)
                if slot is None:
                    break
                b.hbm_slot = slot
                b.h2d_inflight = True
                promos.append(self._desc(b, "h2d"))
                self.dram_hit_blocks += 1
            self._ref_block(req_id, b)
            self.cache_hit_blocks += 1
            cached_tokens = (i + 1) * block_size
        if cached_tokens:
            self.cache_hit_tokens += cached_tokens
        return cached_tokens, promos

    def register_hashes(self, req_id: int, chain: Sequence[int],
                        upto_blocks: int) -> None:
        """Content-address the request's fully written prompt blocks so later
        requests with the same prefix can share them."""
        if not self.prefix_cache:
            return
        ids = self._by_req.get(req_id, [])
        for i in range(min(upto_blocks, len(chain), len(ids))):
            b = self._blocks[ids[i]]
            if b.hash is None:
                b.hash = chain[i]
            self._hash_index.setdefault(chain[i], b.block_id)

    def complete_promotion(self, block_id: int) -> None:
        """A DRAM-tier cache hit's H2D landed: block resident in both tiers."""
        b = self._blocks.get(block_id)
        if b is None:
            return
        b.h2d_inflight = False
        if b.loc == BlockLoc.DRAM and b.hbm_slot is not None:
            b.loc = BlockLoc.BOTH
        self._mut += 1

    def _ref_block(self, req_id: int, b: Block) -> None:
        if not b.ref_ids:                    # leaving the refcount-0 cache
            self._cached_lru.pop(b.block_id, None)
            self._mut += 1
        b.ref_ids.add(req_id)
        self._touch(b)
        self._by_req.setdefault(req_id, []).append(b.block_id)

    def _cow_block(self, req_id: int, src: Block, index: int
                   ) -> Optional[Block]:
        """Fork a shared block whose tail this request will overwrite. The
        copy is an intra-HBM D2D move (negligible next to the C2C link), so
        only the slot cost is modeled."""
        if src.loc not in (BlockLoc.HBM, BlockLoc.BOTH) or src.h2d_inflight:
            return None                      # DRAM-tier tail: not worth a CoW
        self._touch(src)                     # keep the source off the LRU head
        slot = self._take_hbm_slot(exclude={src.block_id})
        if slot is None:
            return None
        b = Block(self._next_id, index, BlockLoc.HBM,
                  ref_ids={req_id}, hbm_slot=slot)
        self._next_id += 1
        self._blocks[b.block_id] = b
        self._by_req.setdefault(req_id, []).append(b.block_id)
        self._touch(b)
        # record the physical row copy; src slot captured now (the source may
        # be demoted/evicted before the backend drains the queue, but its row
        # bytes stay intact until the next h2d/execute write, which the
        # DuplexKV drain ordering runs strictly after)
        self.pending_d2d.append((src.hbm_slot, slot))
        return b

    # -- cache eviction / demotion --------------------------------------------
    def _evictable_hbm(self) -> int:
        """Refcount-0 cached blocks whose HBM slot could be reclaimed now.
        Memoized on the mutation counter — ``hbm_free`` is read several
        times per engine iteration (scheduler, admission, router policies)
        and the cache LRU grows for the whole run, so the O(#cached) scan
        must not run per read. ``check_invariants`` cross-checks the memo
        against a fresh scan (guards a missed ``_mut`` bump)."""
        if not self.prefix_cache or not self._cached_lru:
            return 0
        if self._evict_memo[0] != self._mut:
            n = sum(1 for bid in self._cached_lru
                    if self._blocks[bid].loc in (BlockLoc.HBM, BlockLoc.BOTH)
                    and not self._blocks[bid].d2h_inflight
                    and not self._blocks[bid].h2d_inflight)
            self._evict_memo = (self._mut, n)
        return self._evict_memo[1]

    def deprioritize_slots(self, slots: Set[int]) -> None:
        """Move the given HBM slots to the COLD end of the free list
        (pipelined mode): a slot freed by ``complete_swap_out`` whose
        outbound D2H is still draining on the link is handed out again only
        when nothing else is free, so swap-in destinations avoid same-slot
        serialization with the in-flight read (``h2d_after_d2h``)."""
        if not slots or not self._hbm_free:
            return
        cold = [s for s in self._hbm_free if s in slots]
        if not cold:
            return
        hot = [s for s in self._hbm_free if s not in slots]
        self._hbm_free[:] = cold + hot

    def _take_hbm_slot(self, exclude: Set[int] = frozenset()
                       ) -> Optional[int]:
        if self._hbm_free:
            return self._hbm_free.pop()
        if self._evict_hbm_block(exclude):
            return self._hbm_free.pop()
        return None

    def _evict_hbm_block(self, exclude: Set[int] = frozenset()) -> bool:
        """Free one HBM slot from the refcount-0 cache, LRU order. Entries
        already demoted host-side (BOTH) are preferred — dropping their HBM
        copy is free, which is exactly what eager demotion buys."""
        if not self.prefix_cache:
            return False
        for want_both in (True, False):
            for bid in list(self._cached_lru):
                b = self._blocks[bid]
                if (bid in exclude or b.d2h_inflight or b.h2d_inflight):
                    continue
                if want_both and b.loc == BlockLoc.BOTH:
                    self._release_hbm(b)
                    b.loc = BlockLoc.DRAM
                    self.demoted_blocks += 1
                    self._mut += 1
                    return True
                if not want_both and b.loc == BlockLoc.HBM:
                    self._release_hbm(b)
                    self._drop_cached(b)
                    self.evicted_blocks += 1
                    return True
        return False

    def _take_dram_slot(self) -> Optional[int]:
        if self._dram_free:
            return self._dram_free.pop()
        if self._evict_dram_block():
            return self._dram_free.pop()
        return None

    def evictable_dram(self) -> int:
        """Refcount-0 cached blocks whose DRAM slot could be reclaimed now —
        the same eligibility rule ``_evict_dram_block`` applies (capacity
        probes like ``DuplexKV.can_import`` must see what eviction can
        actually deliver)."""
        if not self.prefix_cache:
            return 0
        return sum(1 for bid in self._cached_lru
                   if self._blocks[bid].loc in (BlockLoc.DRAM, BlockLoc.BOTH)
                   and not self._blocks[bid].d2h_inflight
                   and not self._blocks[bid].h2d_inflight)

    def _evict_dram_block(self, exclude: Set[int] = frozenset()) -> bool:
        """Free one DRAM slot from the cache: DRAM-only entries first (they
        die entirely), then BOTH entries (which keep their HBM copy)."""
        if not self.prefix_cache:
            return False
        for dram_only in (True, False):
            for bid in list(self._cached_lru):
                b = self._blocks[bid]
                if bid in exclude or b.d2h_inflight or b.h2d_inflight:
                    continue
                if dram_only and b.loc == BlockLoc.DRAM:
                    self._drop_cached(b)
                    self.evicted_blocks += 1
                    return True
                if not dram_only and b.loc == BlockLoc.BOTH:
                    self._dram_free.append(b.dram_slot)
                    b.dram_slot = None
                    b.loc = BlockLoc.HBM
                    self._mut += 1
                    return True
        return False

    def _drop_cached(self, b: Block) -> None:
        """Fully evict a refcount-0 cached block (slots recycled by caller
        for HBM; DRAM slot returned here)."""
        self._cached_lru.pop(b.block_id, None)
        self._mut += 1
        if b.hash is not None and self._hash_index.get(b.hash) == b.block_id:
            del self._hash_index[b.hash]
        if b.dram_slot is not None and b.loc in (BlockLoc.DRAM, BlockLoc.BOTH):
            self._dram_free.append(b.dram_slot)
        self._blocks.pop(b.block_id, None)

    def _touch(self, b: Block) -> None:
        self._tick += 1
        b.last_used = self._tick
        if b.block_id in self._cached_lru:
            self._cached_lru.move_to_end(b.block_id)

    # -- eager rotation ---------------------------------------------------------
    def eager_candidates(self, limit: int,
                         exclude_reqs: Set[int] = frozenset(),
                         exclude_slots: Set[int] = frozenset()
                         ) -> List[TransferDesc]:
        """Synced HBM-only blocks to copy to DRAM in the background. With the
        prefix cache on, refcount-0 cached HBM entries qualify too — this is
        the demotion path that makes their later eviction free.
        ``exclude_slots``: HBM rows the current iteration's kernels WRITE
        (pipelined mode) — a block is marked synced on its LOGICAL token
        count, one token ahead of the physical KV write, so the tail block
        of a still-decoding request can be synced while its last row slot is
        written this very iteration; demoting it concurrently would copy the
        row mid-write (guard_compute would fire)."""
        descs = []
        for b in self._blocks.values():
            if len(descs) >= limit or not self._dram_free:
                break
            if (b.loc == BlockLoc.HBM and b.synced and not b.d2h_inflight
                    and not b.h2d_inflight
                    and b.hbm_slot not in exclude_slots
                    and not (b.ref_ids & exclude_reqs)):
                b.dram_slot = self._dram_free.pop()
                b.d2h_inflight = True
                self._mut += 1
                descs.append(self._desc(b, "d2h"))
        return descs

    def complete_d2h(self, block_id: int) -> None:
        b = self._blocks.get(block_id)
        if b is None:
            return
        b.d2h_inflight = False
        if b.loc == BlockLoc.HBM:
            b.loc = BlockLoc.BOTH
        self._mut += 1
        self.eager_d2h_blocks += 1

    # -- preemption (swap-out) ----------------------------------------------------
    def preempt(self, req_id: int) -> List[TransferDesc]:
        """Rotate a request out of HBM. BOTH blocks are freed instantly; only
        blocks without a DRAM copy need a transfer. Shared prefix blocks
        (refcount > 1) stay resident — other live requests read them.
        Returns D2H descriptors; call complete_swap_out(req_id) when they
        land."""
        descs = []
        for bid in self._by_req.get(req_id, []):
            b = self._blocks[bid]
            if b.ref_count > 1:
                continue
            if b.loc == BlockLoc.BOTH:
                self._release_hbm(b)
                b.loc = BlockLoc.DRAM
                self.preempt_free_blocks += 1
            elif b.loc == BlockLoc.HBM:
                if b.d2h_inflight:      # eager copy already in flight: let it land
                    continue
                slot = self._take_dram_slot()
                if slot is None:
                    raise OutOfBlocks("DRAM exhausted during preemption")
                b.dram_slot = slot
                b.d2h_inflight = True
                descs.append(self._desc(b, "d2h"))
                self.preempt_d2h_blocks += 1
        return descs

    def complete_swap_out(self, req_id: int) -> None:
        """All D2H for a preempted request landed: drop HBM residency
        (shared prefix blocks keep theirs)."""
        for bid in self._by_req.get(req_id, []):
            b = self._blocks[bid]
            if b.ref_count > 1:
                continue
            b.d2h_inflight = False
            if b.loc in (BlockLoc.HBM, BlockLoc.BOTH):
                self._release_hbm(b)
                b.loc = BlockLoc.DRAM
                b.synced = True

    # -- swap-in ---------------------------------------------------------------
    def swap_in(self, req_id: int) -> List[TransferDesc]:
        """All-or-nothing: either every DRAM-resident block of the request
        gets an HBM destination (descriptors returned), or no state changes
        and ``OutOfBlocks`` is raised. A partial failure must roll back —
        otherwise the half-assigned blocks keep ``h2d_inflight`` with their
        descriptors discarded, a later retry skips them (already
        "in flight"), and ``complete_swap_in`` marks them resident without
        their data ever having moved. The up-front budget check makes the
        mid-loop failure reachable only when cached-block eviction
        under-delivers (exclusions/in-flight races), so the rollback is the
        rare path."""
        descs = []
        need = [self._blocks[bid] for bid in self._by_req.get(req_id, [])
                if self._blocks[bid].loc == BlockLoc.DRAM
                and not self._blocks[bid].h2d_inflight]
        if len(self._hbm_free) + self._evictable_hbm() < len(need):
            raise OutOfBlocks("HBM exhausted during swap-in")
        taken = []
        for b in need:
            slot = self._take_hbm_slot()
            if slot is None:
                for tb in taken:              # roll back: nothing moved yet
                    self._hbm_free.append(tb.hbm_slot)
                    tb.hbm_slot = None
                    tb.h2d_inflight = False
                    self.swapin_h2d_blocks -= 1
                raise OutOfBlocks("HBM exhausted during swap-in")
            b.hbm_slot = slot
            b.h2d_inflight = True
            taken.append(b)
            descs.append(self._desc(b, "h2d"))
            self.swapin_h2d_blocks += 1
        return descs

    def complete_swap_in(self, req_id: int) -> None:
        for bid in self._by_req.get(req_id, []):
            b = self._blocks[bid]
            if b.h2d_inflight:
                b.h2d_inflight = False
                b.loc = BlockLoc.BOTH   # DRAM copy retained (free re-preempt)

    # -- cross-replica migration (export / import) --------------------------------
    def migrate_out(self, req_id: int) -> List[TransferDesc]:
        """D2H descriptors that give EVERY block of the request a DRAM copy
        — the first half of a cross-replica handoff. Blocks already
        ``BOTH``/``DRAM`` (eager demotion, earlier rotations) need no
        transfer: that is the eager-rotation dividend the disaggregation
        design banks on. Unlike ``preempt``, shared (refcount > 1) blocks
        are copied too — the target replica needs their data while the
        source keeps serving its other referents. All-or-nothing on DRAM
        capacity: a mid-loop slot failure rolls back and raises."""
        descs: List[TransferDesc] = []
        for bid in self._by_req.get(req_id, []):
            b = self._blocks[bid]
            if b.loc in (BlockLoc.DRAM, BlockLoc.BOTH):
                continue               # host copy already exists
            if b.d2h_inflight or b.h2d_inflight:
                # migrations run between engine iterations; sim transfers
                # complete within plan_iteration, so an in-flight flag here
                # means the caller broke the ordering contract
                raise RuntimeError(
                    f"migrate_out({req_id}): block {bid} has a transfer in "
                    f"flight")
            slot = self._take_dram_slot()
            if slot is None:
                for d in descs:        # roll back: nothing moved yet
                    rb = self._blocks[d.block_id]
                    self._dram_free.append(rb.dram_slot)
                    rb.dram_slot = None
                    rb.d2h_inflight = False
                    self.migrate_d2h_blocks -= 1
                raise OutOfBlocks("DRAM exhausted during migration export")
            b.dram_slot = slot
            b.d2h_inflight = True
            descs.append(self._desc(b, "d2h"))
            self.migrate_d2h_blocks += 1
        return descs

    def complete_migrate_out(self, req_id: int) -> None:
        """All migration D2H landed: every block of the request is now
        host-resident (``BOTH`` keeps the HBM copy — live sharers and the
        cache may still read it)."""
        for bid in self._by_req.get(req_id, []):
            b = self._blocks[bid]
            b.d2h_inflight = False
            if b.loc == BlockLoc.HBM and b.dram_slot is not None:
                b.loc = BlockLoc.BOTH
                b.synced = True
                self._mut += 1

    def export_request(self, req_id: int) -> List[ExportedBlockMeta]:
        """Hand the request's blocks off to another table: returns ordered
        metadata describing each block, then releases the request's
        references here (decref-and-retain — shared prefixes and
        content-addressed cache entries stay behind for the source's own
        traffic). Precondition: ``complete_migrate_out`` ran, so every block
        has a DRAM copy. ``moved`` is derived from the release's actual
        outcome (the block no longer exists here), never predicted: a block
        the source freed travels zero-copy (the caller pops its host
        payload); a retained one (live sharers or cache retention) is shared
        by reference."""
        staged = []                      # (bid, position, hash, synced, slot)
        for pos, bid in enumerate(self._by_req.get(req_id, [])):
            b = self._blocks[bid]
            if b.dram_slot is None or b.loc not in (BlockLoc.DRAM,
                                                    BlockLoc.BOTH):
                raise RuntimeError(
                    f"export_request({req_id}): block {bid} has no DRAM "
                    f"copy ({b.loc}) — run migrate_out first")
            staged.append((bid, pos, b.hash, b.synced, b.dram_slot))
        self.release_request(req_id)
        metas = [ExportedBlockMeta(
            position=pos, hash=h, synced=synced, src_dram_slot=slot,
            nbytes=self.block_bytes, moved=bid not in self._blocks)
            for bid, pos, h, synced, slot in staged]
        self.exported_blocks += len(metas)
        return metas

    def import_request(self, req_id: int, metas: Sequence[ExportedBlockMeta]
                       ) -> Tuple[List[Block], List[Tuple[int, Block]]]:
        """Adopt a migrated request's blocks into THIS table on the DRAM
        tier. A content-addressed hit on an existing synced block shares it
        instead of duplicating (cross-replica prefix dedup — migrated shared
        prefixes stay shared); every other block becomes a new DRAM-resident
        block whose payload the caller installs. Returns ``(shared,
        created)`` where ``created`` pairs each new block with the index of
        its meta (payload lookup). All-or-nothing: capacity is secured (DRAM
        cache evictions included) before any state mutates."""
        if req_id in self._by_req:
            raise ValueError(f"import_request: {req_id} already has blocks")
        plan: List[Tuple[int, Optional[int]]] = []   # (meta idx, share bid)
        n_alloc = 0
        for i, m in enumerate(metas):
            bid = (self._hash_index.get(m.hash)
                   if m.hash is not None else None)
            tb = self._blocks.get(bid) if bid is not None else None
            if (tb is not None and tb.synced and not tb.d2h_inflight
                    and not tb.h2d_inflight):
                plan.append((i, bid))
            else:
                plan.append((i, None))
                n_alloc += 1
        # secure DRAM capacity up front (evicting cold cache entries is
        # allowed to fund the import, but never the blocks this import will
        # share) so the loop below cannot fail midway
        planned = {bid for _, bid in plan if bid is not None}
        while len(self._dram_free) < n_alloc:
            if not self._evict_dram_block(exclude=planned):
                raise OutOfBlocks(
                    f"DRAM exhausted during migration import: need {n_alloc}"
                    f" slots, have {len(self._dram_free)}")
        shared: List[Block] = []
        created: List[Tuple[int, Block]] = []
        for i, share_bid in plan:
            m = metas[i]
            if share_bid is not None and share_bid in self._blocks:
                tb = self._blocks[share_bid]
                self._ref_block(req_id, tb)
                self.cache_hit_blocks += 1
                self.import_shared_blocks += 1
                shared.append(tb)
                continue
            b = Block(self._next_id,
                      len(self._by_req.get(req_id, [])), BlockLoc.DRAM,
                      ref_ids={req_id}, synced=m.synced, hash=m.hash,
                      dram_slot=self._dram_free.pop())
            self._next_id += 1
            self._blocks[b.block_id] = b
            self._by_req.setdefault(req_id, []).append(b.block_id)
            if self.prefix_cache and m.hash is not None:
                self._hash_index.setdefault(m.hash, b.block_id)
            self._touch(b)
            created.append((i, b))
        self.imported_blocks += len(created)
        return shared, created

    # -- release (decref-and-retain) ---------------------------------------------
    def release_request(self, req_id: int) -> None:
        """Drop the request's references. A block reaching refcount 0 is
        retained in the prefix cache when it is content-addressed (hashed +
        synced); otherwise its slots are freed immediately (always, when the
        cache is disabled)."""
        for bid in self._by_req.pop(req_id, []):
            b = self._blocks.get(bid)
            if b is None:
                continue
            b.ref_ids.discard(req_id)
            if b.ref_ids:
                continue
            if (self.prefix_cache and b.hash is not None and b.synced
                    and self._hash_index.get(b.hash, bid) == bid):
                self._hash_index.setdefault(b.hash, bid)
                self._cached_lru[bid] = None
                self._mut += 1
                self._touch(b)
                self.retained_blocks += 1
            else:
                self._free_block(b)

    def _free_block(self, b: Block) -> None:
        if b.hash is not None and self._hash_index.get(b.hash) == b.block_id:
            del self._hash_index[b.hash]
        if b.hbm_slot is not None and b.loc in (BlockLoc.HBM, BlockLoc.BOTH):
            self._hbm_free.append(b.hbm_slot)
        if b.dram_slot is not None and b.loc in (BlockLoc.DRAM, BlockLoc.BOTH):
            self._dram_free.append(b.dram_slot)
        self._blocks.pop(b.block_id, None)

    # -- pipelined-execution hazard check -----------------------------------------
    def set_compute_rows(self, reads: Set[int], writes: Set[int]) -> None:
        """Declare the HBM slots the CURRENT iteration's kernels touch.
        ``reads`` = decode context rows + prefill rows already written;
        ``writes`` = rows receiving new KV this iteration (decode tail
        blocks, the prefill chunk's rows). The engine calls this right
        before dispatching kernels and ``clear_compute_rows`` after the
        iteration commits; while set, ``guard_compute`` (and
        ``check_invariants``) assert no in-flight transfer races them."""
        self.compute_reads = set(reads)
        self.compute_writes = set(writes)
        self.guard_compute()

    def clear_compute_rows(self) -> None:
        self.compute_reads = set()
        self.compute_writes = set()

    def guard_compute(self) -> None:
        """Row-level transfer/compute hazard check (pipelined mode).

        * An in-flight H2D is WRITING its HBM slot — compute may neither
          read nor write that row until ``complete_swap_in``/promotion.
        * An in-flight D2H is READING its HBM slot — compute may not WRITE
          that row; concurrent compute READS are legal (eager rotation
          reads synced, never-rewritten blocks — that concurrency is the
          paper's point).
        """
        if not (self.compute_reads or self.compute_writes):
            return
        touched = self.compute_reads | self.compute_writes
        for b in self._blocks.values():
            if b.hbm_slot is None:
                continue
            if b.h2d_inflight and b.hbm_slot in touched:
                raise RuntimeError(
                    f"hazard: HBM slot {b.hbm_slot} (block {b.block_id}) is "
                    "an in-flight H2D destination but is scheduled for "
                    "compute this iteration")
            if b.d2h_inflight and b.hbm_slot in self.compute_writes:
                raise RuntimeError(
                    f"hazard: HBM slot {b.hbm_slot} (block {b.block_id}) is "
                    "being read by an in-flight D2H but compute writes it "
                    "this iteration")

    # -- invariants (tested) ------------------------------------------------------
    def check_invariants(self) -> None:
        self.guard_compute()
        hbm_used = set()
        dram_used = set()
        referenced: Dict[int, Set[int]] = {}
        for rid, bids in self._by_req.items():
            for bid in bids:
                referenced.setdefault(bid, set()).add(rid)
        for b in self._blocks.values():
            assert b.ref_ids == referenced.get(b.block_id, set()), \
                f"refcount drift on block {b.block_id}"
            if b.ref_ids:
                assert b.block_id not in self._cached_lru, \
                    "referenced block sitting in the refcount-0 cache"
            else:
                assert b.block_id in self._cached_lru, \
                    "refcount-0 block neither cached nor freed (leak)"
            if b.loc in (BlockLoc.HBM, BlockLoc.BOTH) or b.h2d_inflight:
                assert b.hbm_slot is not None
                assert b.hbm_slot not in hbm_used, "HBM slot double-booked"
                hbm_used.add(b.hbm_slot)
            if b.loc in (BlockLoc.DRAM, BlockLoc.BOTH) or b.d2h_inflight:
                assert b.dram_slot is not None
                assert b.dram_slot not in dram_used, "DRAM slot double-booked"
                dram_used.add(b.dram_slot)
            assert not (b.d2h_inflight and b.h2d_inflight), \
                "block is both swap-in dst and swap-out src (data race)"
        for h, bid in self._hash_index.items():
            assert bid in self._blocks, "hash index points at a dead block"
            assert self._blocks[bid].hash == h, "hash index mismatch"
        assert not (hbm_used & set(self._hbm_free)), "freed slot still in use"
        assert len(hbm_used) + len(self._hbm_free) <= self.num_hbm_blocks
        if self.prefix_cache:
            raw = sum(1 for bid in self._cached_lru
                      if self._blocks[bid].loc in (BlockLoc.HBM, BlockLoc.BOTH)
                      and not self._blocks[bid].d2h_inflight
                      and not self._blocks[bid].h2d_inflight)
            assert self._evictable_hbm() == raw, \
                "evictable-count memo drifted (missed _mut bump)"

    # -- helpers --------------------------------------------------------------
    def _release_hbm(self, b: Block) -> None:
        if b.hbm_slot is not None:
            self._hbm_free.append(b.hbm_slot)
            b.hbm_slot = None

    def _desc(self, b: Block, direction: str) -> TransferDesc:
        src = b.hbm_slot if direction == "d2h" else b.dram_slot
        dst = b.dram_slot if direction == "d2h" else b.hbm_slot
        rid = min(b.ref_ids) if b.ref_ids else -1
        return TransferDesc(b.block_id, rid, direction, src, dst,
                            self.block_bytes, self.segments_per_block)
