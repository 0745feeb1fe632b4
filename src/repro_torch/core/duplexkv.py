"""DuplexKV rotation engine: block table + transfer engine + eager rotation
+ the two-tier prefix cache front door.

Per engine iteration the serving loop calls:
  plan_iteration(preempt_reqs, swapin_reqs) ->
      IterationTransfers(d2h, h2d, time model), plus background eager D2H
      filling leftover duplex capacity.

Non-duplex modes do NOT run eager rotation (the paper's MS/MS+MK ablations),
so preemption pays full D2H cost and the directions serialize — exactly the
behaviour Table 1 measures.

Prefix cache (``ServingConfig.prefix_cache``): ``lookup_prefix`` chains the
prompt's per-block content hashes and asks the table to share any cached
prefix blocks; DRAM-tier hits queue promotion H2D transfers that ride the
next ``plan_iteration``'s duplex H2D direction (they complete within the
iteration, like swap-ins). ``finish`` becomes decref-and-retain. Disabled
(the default), every path is bit-identical to the exclusive-ownership
engine.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.configs.base import HardwareProfile, ModelConfig, ServingConfig
from repro_torch.core.blocktable import (BlockLoc, ExportedBlockMeta, KVView,
                                         OutOfBlocks, TransferDesc,
                                         TwoTierBlockTable)
from repro_torch.core.transfer import TransferEngine, TransferStats, engine_for_flags

# Root of the chained prefix hash (an arbitrary fixed odd constant; Python
# hashes ints/tuples-of-ints deterministically, so chains are stable across
# processes regardless of PYTHONHASHSEED).
_HASH_ROOT = 0x5EED_C2C1


def prefix_hash_chain(prompt_ids: Sequence[int], block_size: int) -> List[int]:
    """Chained content hashes over the prompt's *full* blocks:
    ``h_i = hash((h_{i-1}, tokens[i*bs:(i+1)*bs]))``."""
    n_full = len(prompt_ids) // block_size
    chain: List[int] = []
    h = _HASH_ROOT
    for i in range(n_full):
        h = hash((h, tuple(int(t) for t in
                           prompt_ids[i * block_size:(i + 1) * block_size])))
        chain.append(h)
    return chain


def block_bytes_of(cfg: ModelConfig, block_size: int,
                   kv_dtype: str = "bf16") -> Tuple[int, int]:
    """(bytes per KV block across all layers, segments in layer-first layout).

    ``kv_dtype`` selects the cache storage tier: ``"bf16"`` (default)
    stores KV in the model's own dtype (element width from
    ``ModelConfig.dtype``); ``"int8"`` stores 1-byte values plus one fp32
    scale per (layer, K/V side, kv head) of the block — the quantized
    tier's ~2x bytes-per-block cut is what doubles both admission capacity
    per HBM budget and effective rotation throughput per C2C byte.

    SSM/hybrid: attention layers contribute paged KV; SSM state is rotated as
    one pseudo-block per request (handled by the engine); here we size the
    paged block only. Attention-free models get a nominal state block.
    """
    per_token = cfg.kv_bytes_per_token()
    # one segment per attention layer (K+V of one block in that layer —
    # the paper's S_seg = P·C accounting: 64 KB for Qwen2.5-32B)
    n_seg = max(cfg.num_attn_layers, 1)
    if per_token == 0:  # attention-free: one state "block"
        s = cfg.ssm
        d_in = s.expand * cfg.d_model
        h = d_in // s.head_dim
        state = (h * s.head_dim * s.state_dim + (s.conv_width - 1)
                 * (d_in + 2 * s.state_dim)) * 2 * cfg.num_layers
        return state, cfg.num_layers
    if kv_dtype == "int8":
        values = cfg.kv_bytes_per_token(dtype_bytes=1) * block_size
        scales = cfg.num_attn_layers * 2 * cfg.num_kv_heads * 4
        return values + scales, n_seg
    return per_token * block_size, n_seg


def hbm_block_capacity(cfg: ModelConfig, block_size: int, hbm_bytes: int,
                       kv_dtype: str = "bf16") -> int:
    """Blocks an HBM byte budget admits at this storage tier — what the
    AdmissionController's block pool should be sized to. The int8 tier fits
    ~2x the bf16 count for the same budget (scale rows cost one fp32 per
    (layer, side, head) per block against P·D int8 values)."""
    bb, _ = block_bytes_of(cfg, block_size, kv_dtype=kv_dtype)
    return max(int(hbm_bytes) // bb, 1)


@dataclasses.dataclass
class MigrationExport:
    """A request's KV leaving this replica for another one (disaggregated
    prefill/decode handoff, serving/disagg.py). ``payloads`` aligns with
    ``metas``: the host-tier row arrays in real (paged-runner) mode, all
    ``None`` in sim mode. ``stats`` times the fresh D2H the export needed —
    blocks the eager-demotion path already copied host-side ride for free."""
    req_id: int
    metas: List[ExportedBlockMeta]
    payloads: List[Optional[object]]
    chain: Optional[List[int]]          # prefix hash chain (target re-registers)
    stats: TransferStats
    d2h_blocks: int                     # blocks that needed a fresh D2H

    @property
    def nbytes(self) -> int:
        return sum(m.nbytes for m in self.metas)


@dataclasses.dataclass
class IterationTransfers:
    stats: TransferStats
    eager_stats: Optional[TransferStats]
    swapout_done: List[int]       # req_ids whose D2H completed this iteration
    swapin_done: List[int]        # req_ids whose H2D completed this iteration
    # pipelined-timeline metadata (core.py maps these onto PipelineTimeline
    # dependency flags; meaningless — and ignored — in synchronous mode)
    promo_blocks: int = 0         # DRAM-tier promotions riding this H2D
    h2d_after_d2h: bool = False   # an H2D dst slot aliases a D2H src slot


class DuplexKV:
    def __init__(self, cfg: ModelConfig, serving: ServingConfig,
                 hw: HardwareProfile):
        self.cfg = cfg
        self.serving = serving
        self.hw = hw
        self.kv_dtype = getattr(serving, "kv_dtype", "bf16")
        bb, segs = block_bytes_of(cfg, serving.block_size,
                                  kv_dtype=self.kv_dtype)
        self.block_bytes = bb
        layout_segs = 1 if serving.block_first_layout else segs
        self.prefix_cache = serving.prefix_cache
        self.table = TwoTierBlockTable(serving.num_hbm_blocks,
                                       serving.num_dram_blocks,
                                       bb, layout_segs,
                                       prefix_cache=serving.prefix_cache)
        # Tensor parallelism: the KV pool's kv-head dim shards over tp
        # Superchips, so each shard's C2C link moves 1/kv_shards of every
        # row, concurrently. tp == 1 skips the plan entirely (bit-identical
        # golden path); replicate-fallback plans (tp > num_kv_heads) keep
        # kv_shards == 1 — every chip moves full rows.
        tp = int(getattr(serving, "tp", 1) or 1)
        if tp > 1:
            from repro_torch.distributed.tp import plan_tp_sharding
            self.kv_shards = plan_tp_sharding(cfg, tp).kv_shards
        else:
            self.kv_shards = 1
        self.engine = engine_for_flags(
            hw, block_first=serving.block_first_layout,
            batched_kernel=serving.batched_transfer_kernel,
            duplex=serving.duplex, shards=self.kv_shards)
        # cumulative transfer-byte accounting (global and per-shard)
        self.d2h_bytes_total = 0
        self.h2d_bytes_total = 0
        # cumulative per-direction channel BUSY seconds (sim model time) —
        # the flight recorder's channel-utilization counters
        self.d2h_busy_s_total = 0.0
        self.h2d_busy_s_total = 0.0
        self.eager = serving.eager_rotation and serving.duplex
        # Cross-iteration pipeline: eager D2H issued during iteration N keeps
        # its in-flight flags set while N's kernels execute (the copies
        # stream under compute) and settles at the next plan_iteration. Sync
        # mode settles within the iteration — bit-identical to the golden.
        self.pipelined = bool(getattr(serving, "pipeline", False))
        self._carry_eager: List[TransferDesc] = []
        self._chains: Dict[int, List[int]] = {}     # req_id -> prefix hashes
        self._promotions: List[TransferDesc] = []   # queued DRAM-hit H2D
        self.cache_lookup_tokens = 0                # prompt tokens probed
        # Optional physical data backend (PagedModelRunner's pool store):
        # when attached, every transfer descriptor this engine times is ALSO
        # executed as real row movement (device pool <-> host numpy tier).
        self.data = None
        # rows the backend moved to the host tier for eager demotion (in
        # the iteration, or carried to the next in pipelined mode: the rows
        # move when issued either way), and the host wall spent on them;
        # the rest of the backend's D2H rows are rotation's and migration's
        self.eager_d2h_rows = 0
        self.eager_d2h_wall_s = 0.0

    def attach_data_backend(self, backend) -> None:
        """Attach a physical KV store. ``backend`` must provide
        ``run_d2d(pairs)``, ``run_d2h(descs)`` and ``run_h2d(descs)``."""
        self.data = backend

    # -- prefix cache ------------------------------------------------------------
    def lookup_prefix(self, req_id: int,
                      prompt_ids: Optional[Sequence[int]]) -> int:
        """Content-addressed prefix lookup for a newly arrived request.
        Shares (increfs) every cached prefix block, queues promotion H2D for
        DRAM-tier hits, and returns the number of prompt tokens whose KV is
        already resident. Capped at ``len(prompt_ids) - 1`` so at least one
        prompt token is always prefilled (first-token logits)."""
        if not self.prefix_cache or not prompt_ids:
            return 0
        chain = prefix_hash_chain(prompt_ids, self.serving.block_size)
        if not chain:
            return 0
        self._chains[req_id] = chain
        self.cache_lookup_tokens += len(prompt_ids)
        cached, promos = self.table.match_prefix(
            req_id, chain, max_tokens=len(prompt_ids) - 1,
            block_size=self.serving.block_size)
        self._promotions.extend(promos)
        return cached

    def drop_prefix_refs(self, req_id: int) -> None:
        """Un-pin a still-waiting request's cache-hit blocks (the engine's
        stall-breaker): the blocks return to refcount 0 — evictable again —
        and the request re-enters admission uncached. Its hash chain is
        kept so the blocks it eventually prefills still register."""
        self.table.release_request(req_id)

    def cache_counters(self) -> Dict[str, int]:
        """Prefix-cache counters (per replica; the router sums them)."""
        t = self.table
        return dict(cache_hit_tokens=t.cache_hit_tokens,
                    cache_hit_blocks=t.cache_hit_blocks,
                    cache_lookup_tokens=self.cache_lookup_tokens,
                    dram_hit_blocks=t.dram_hit_blocks,
                    cow_blocks=t.cow_blocks,
                    retained_blocks=t.retained_blocks,
                    demoted_blocks=t.demoted_blocks,
                    evicted_blocks=t.evicted_blocks,
                    cached_blocks=t.cached_blocks)

    def transfer_counters(self) -> Dict[str, int]:
        """Cumulative link-traffic counters (per replica). Global bytes are
        what the pool logically moved; per-shard bytes are what ONE chip's
        C2C link actually carried (== global / kv_shards)."""
        return dict(kv_shards=self.kv_shards,
                    d2h_bytes=self.d2h_bytes_total,
                    h2d_bytes=self.h2d_bytes_total,
                    d2h_bytes_per_shard=self.d2h_bytes_total // self.kv_shards,
                    h2d_bytes_per_shard=self.h2d_bytes_total // self.kv_shards,
                    d2h_busy_s=self.d2h_busy_s_total,
                    h2d_busy_s=self.h2d_busy_s_total)

    # -- scheduler residency view --------------------------------------------------
    def scheduler_view(self, requests) -> KVView:
        """Residency snapshot for the scheduler's block accounting: admission
        demand shrinks by HBM-resident (cached/shared) blocks; preemption
        credit shrinks to exclusively held blocks."""
        from repro_torch.core.types import RequestState
        view = KVView()
        for r in requests:
            if r.state in (RequestState.WAITING, RequestState.ROTARY):
                view.resident[r.req_id] = self.hbm_resident(r.req_id)
            elif r.state == RequestState.RUNNING:
                view.releasable[r.req_id] = self.releasable_hbm(r.req_id)
        return view

    def hbm_resident(self, req_id: int) -> int:
        return self.table.hbm_blocks_of(req_id)

    def releasable_hbm(self, req_id: int) -> int:
        return self.table.releasable_hbm_blocks_of(req_id)

    # -- pipelined eager-carry ----------------------------------------------------
    def _settle_carry(self, req_id: Optional[int] = None) -> None:
        """Land eager D2H copies carried across an iteration boundary
        (pipelined mode). ``req_id`` restricts settling to blocks that
        request references — used by ``finish`` so a completing request's
        blocks never free with a dangling in-flight flag (``_free_block``
        would leak the DRAM slot). Blocks whose flag was already cleared by
        another path (a preemption "let it land") just drop from the list;
        the data moved physically at issue time either way."""
        if not self._carry_eager:
            return
        keep: List[TransferDesc] = []
        only = None
        if req_id is not None:
            only = {b.block_id for b in self.table.blocks_of(req_id)}
        for d in self._carry_eager:
            if only is not None and d.block_id not in only:
                keep.append(d)
                continue
            b = self.table._blocks.get(d.block_id)
            if b is not None and b.d2h_inflight:
                self.table.complete_d2h(d.block_id)
        self._carry_eager = keep

    # -- cross-replica migration ----------------------------------------------
    def can_export(self, req_id: int) -> bool:
        """Conservative capacity probe: enough free DRAM slots for the
        blocks a ``migrate_export`` would still have to demote."""
        need = sum(1 for b in self.table.blocks_of(req_id)
                   if b.loc == BlockLoc.HBM)
        return self.table.dram_free >= need

    def can_import(self, n_blocks: int) -> bool:
        """Capacity probe for an import of ``n_blocks``: free DRAM slots
        plus evictable DRAM-resident cache entries (hash sharing can only
        reduce the true demand)."""
        t = self.table
        return (t.dram_free >= n_blocks
                or t.dram_free + t.evictable_dram() >= n_blocks)

    def migrate_export(self, req_id: int) -> MigrationExport:
        """First half of a disaggregated prefill→decode handoff: give every
        block of the request a host-tier copy (the D2H rides the same path
        as eager demotion, so already-demoted blocks are free), time the
        fresh transfers on this replica's link, then release the request
        here — retaining shared prefixes and content-addressed cache entries
        for the source's own traffic. In real (paged) mode the host row
        arrays travel with the export: moved blocks are popped from this
        store (zero-copy), retained ones are handed off by reference (host
        rows are immutable once written — later writes rebind the slot)."""
        self._settle_carry()    # migrations run between engine iterations
        descs = self.table.migrate_out(req_id)
        stats = (self.engine.execute(descs, []) if descs
                 else TransferStats())
        self.d2h_bytes_total += stats.d2h_bytes
        self.d2h_busy_s_total += stats.d2h_time
        if self.data is not None and descs:
            self.data.run_d2h(descs)
        self.table.complete_migrate_out(req_id)
        chain = self._chains.pop(req_id, None)
        metas = self.table.export_request(req_id)
        payloads: List[Optional[object]] = []
        for m in metas:
            arr = None
            if self.data is not None:
                arr = (self.data.host.pop(m.src_dram_slot, None) if m.moved
                       else self.data.host.get(m.src_dram_slot))
                if arr is None:
                    raise RuntimeError(
                        f"migrate_export({req_id}): DRAM slot "
                        f"{m.src_dram_slot} holds no data (lost copy)")
            payloads.append(arr)
        return MigrationExport(req_id=req_id, metas=metas, payloads=payloads,
                               chain=chain, stats=stats,
                               d2h_blocks=len(descs))

    def migrate_import(self, export: MigrationExport) -> Tuple[int, int]:
        """Second half of the handoff: adopt the exported blocks into this
        replica's DRAM tier (zero-copy — host arrays are re-registered under
        this table's slots, no bytes move). Content-addressed blocks the
        target already holds are shared instead of duplicated, so shared
        prefixes stay shared across the migration. The H2D that makes the
        request runnable is NOT issued here: the request re-enters the
        engine ROTARY and its swap-in rides the target's next
        ``plan_iteration`` with full-duplex accounting, exactly like a
        rotary resumption. Returns ``(shared, created)`` block counts."""
        shared, created = self.table.import_request(export.req_id,
                                                    export.metas)
        if self.data is not None:
            for meta_idx, b in created:
                arr = export.payloads[meta_idx]
                if arr is None:
                    raise RuntimeError(
                        f"migrate_import({export.req_id}): no payload for "
                        f"imported block {b.block_id}")
                self.data.host[b.dram_slot] = arr
        if export.chain:
            self._chains[export.req_id] = export.chain
        return len(shared), len(created)

    # -- iteration planning ------------------------------------------------------
    def plan_iteration(self, preempt_reqs: Sequence[int],
                       swapin_reqs: Sequence[int],
                       iteration_budget_s: float,
                       exclude_slots: Set[int] = frozenset()
                       ) -> IterationTransfers:
        # Physical ordering contract (data backend attached): CoW D2D row
        # copies FIRST (their captured src slots may be re-issued as H2D
        # destinations below), then preempt D2H reads, then H2D writes.
        # Model execution (the executor's pool reads/writes) runs strictly
        # after plan_iteration, so every row lands before it is consumed.
        self._settle_carry()    # last iteration's carried eager D2H lands now
        if self.data is not None:
            pending = self.table.drain_pending_d2d()
            if pending:
                self.data.run_d2d(pending)
        else:
            self.table.drain_pending_d2d()   # keep the queue bounded
        d2h: List[TransferDesc] = []
        h2d: List[TransferDesc] = []
        for rid in preempt_reqs:
            d2h.extend(self.table.preempt(rid))
        d2h_src = {d.src_slot for d in d2h}  # slots freed below may be reused
        if self.data is not None and d2h:
            self.data.run_d2h(d2h)           # read rows BEFORE slots free
        # swap-out transfers complete within the iteration (sim semantics);
        # their HBM slots free up BEFORE swap-ins allocate — this ordering is
        # what eager rotation buys: most preempted blocks are BOTH already,
        # so the free pool is large and the two directions never alias.
        for rid in preempt_reqs:
            self.table.complete_swap_out(rid)
        if self.pipelined and d2h_src:
            # freed slots whose outbound D2H is still streaming go to the
            # cold end of the free list — swap-ins take other slots first,
            # so the directions stay genuinely full-duplex (no same-slot
            # serialization unless HBM is completely exhausted)
            self.table.deprioritize_slots(d2h_src)
        admitted: List[int] = []
        for rid in swapin_reqs:
            try:
                h2d.extend(self.table.swap_in(rid))
                admitted.append(rid)
            except OutOfBlocks:  # stays rotary this iteration
                continue
        swapin_reqs = admitted
        # DRAM-tier cache hits promote alongside swap-ins (same duplex H2D)
        promos = self._promotions
        self._promotions = []
        h2d.extend(promos)
        if self.data is not None and h2d:
            self.data.run_h2d(h2d)
        stats = self.engine.execute(d2h, h2d)
        self.d2h_bytes_total += stats.d2h_bytes
        self.h2d_bytes_total += stats.h2d_bytes
        self.d2h_busy_s_total += stats.d2h_time
        self.h2d_busy_s_total += stats.h2d_time

        eager_stats = None
        if self.eager:
            # background eager rotation: fill leftover duplex D2H capacity
            spare_s = max(iteration_budget_s - stats.d2h_time, 0.0)
            cap = self.hw.link.duplex_total_bw / 2
            budget_blocks = int(spare_s * cap / max(self.block_bytes, 1))
            if budget_blocks > 0:
                descs = self.table.eager_candidates(
                    budget_blocks, exclude_reqs=set(preempt_reqs),
                    exclude_slots=exclude_slots)
                if descs:
                    eager_stats = self.engine.execute(descs, [])
                    self.d2h_bytes_total += eager_stats.d2h_bytes
                    self.d2h_busy_s_total += eager_stats.d2h_time
                    if self.data is not None:
                        t0 = time.monotonic_ns()
                        self.data.run_d2h(descs)
                        self.eager_d2h_wall_s += (
                            time.monotonic_ns() - t0) / 1e9
                        self.eager_d2h_rows += len(descs)
                    if self.pipelined:
                        # flags stay set while this iteration's kernels run:
                        # the copy streams under compute (reads-only — eager
                        # blocks are synced and never rewritten) and settles
                        # at the NEXT plan_iteration
                        self._carry_eager.extend(descs)
                    else:
                        for d in descs:
                            self.table.complete_d2h(d.block_id)

        # completions (the sim advances time; real mode would poll events)
        for d in promos:
            self.table.complete_promotion(d.block_id)
        for rid in swapin_reqs:
            self.table.complete_swap_in(rid)
        return IterationTransfers(
            stats=stats, eager_stats=eager_stats,
            swapout_done=list(preempt_reqs), swapin_done=list(swapin_reqs),
            promo_blocks=len(promos),
            h2d_after_d2h=bool(d2h_src & {d.dst_slot for d in h2d}))

    # -- capacity API used by the engine/scheduler ---------------------------------
    @property
    def hbm_free_blocks(self) -> int:
        return self.table.hbm_free

    def grow(self, req_id: int, new_total_blocks: int) -> None:
        have = len(self.table.blocks_of(req_id))
        if new_total_blocks > have:
            self.table.alloc(req_id, new_total_blocks - have)

    def sync_progress(self, req_id: int, tokens: int,
                      written_from: Optional[int] = None) -> None:
        """Mark fully-filled blocks as synced (eager-rotation candidates) and
        content-address full prompt blocks (prefix-cache mode).
        ``written_from``: first token position this iteration's writes
        touched (physical mode invalidates host copies from its block on)."""
        full = tokens // self.serving.block_size
        if self.data is not None:
            # physical mode: a host copy of a block that just got new tokens
            # is stale — drop it so the next preemption re-transfers. Gated
            # on the backend so the sim path stays golden-bit-identical.
            start = (written_from if written_from is not None
                     else max(tokens - 1, 0)) // self.serving.block_size
            self.table.invalidate_dirty_tail(req_id, start)
        self.table.mark_synced(req_id, full)
        chain = self._chains.get(req_id)
        if chain:
            self.table.register_hashes(req_id, chain, full)

    def finish(self, req_id: int) -> None:
        """Decref-and-retain: content-addressed blocks stay cached at
        refcount 0; everything else (and everything, with the cache off)
        frees immediately."""
        self._settle_carry(req_id)   # land carried copies before blocks free
        self._chains.pop(req_id, None)
        self.table.release_request(req_id)

    def b_xfer_effective(self) -> int:
        """Blocks/iteration the link can sustain (reflects swap bandwidth)."""
        rate = self.engine.sustained_block_rate(
            self.block_bytes, self.table.segments_per_block)
        # per ~50ms iteration
        return max(int(rate * 0.05), 1)
