"""Cross-replica KV migration engine for disaggregated prefill/decode
serving (see DESIGN.md §Disaggregation).

A migration hands one request's KV blocks from a *prefill* replica to a
*decode* replica through the DRAM tier, in three legs:

  1. **D2H on the source** — rides the eager-demotion path: only blocks
     without a host copy transfer; anything eager rotation already demoted
     is free. Timed on the source's own ``TransferEngine``. The D2H
     direction of a prefill replica's duplex link is otherwise idle (prefill
     replicas rarely rotate), so the export does not contend with the
     source's serving traffic — the same co-design argument the paper makes
     for eager rotation.
  2. **Host-side slot handoff** — zero-copy: the DRAM row payloads are
     re-registered under the target table's slots (real mode moves host row
     *references*, sim mode moves bookkeeping only). Content hashes
     and refcounts survive the hop, so shared prefixes stay shared — on the
     source (retained for its own cache) and on the target (a second
     migrated request with the same prefix shares the first one's imported
     blocks).
  3. **H2D on the target** — NOT issued here. The request re-enters the
     target engine in the ROTARY state and its swap-in rides the target's
     next ``plan_iteration`` with full-duplex accounting, competing with —
     and therefore gated behind — the target's own rotation traffic (the
     watermark in serving/disagg.py).

``MigrationEngine`` owns the mechanics and the accounting; *placement*
policy (which decode replica, when to defer, when to fall back to
colocation) lives in ``serving.disagg.DisaggCluster``.
"""
from __future__ import annotations

import dataclasses
from typing import List

from repro_torch.core.duplexkv import DuplexKV, MigrationExport


@dataclasses.dataclass
class MigrationRecord:
    """One completed handoff."""
    req_id: int
    t_start: float                 # source clock at export
    t_ready: float                 # when the target may ingest (D2H landed)
    blocks: int                    # blocks the request carried
    d2h_blocks: int                # blocks that needed a fresh D2H
    free_blocks: int               # blocks already host-resident (free leg)
    shared_on_target: int          # imports served by a target hash hit
    nbytes: int                    # payload bytes (all blocks)
    d2h_bytes: int                 # bytes actually moved over the link
    d2h_time_s: float

    @property
    def latency_s(self) -> float:
        return self.t_ready - self.t_start


@dataclasses.dataclass
class MigrationStats:
    """Aggregate counters (the bench/serve surfaces report these)."""
    migrations: int = 0
    blocks: int = 0
    d2h_blocks: int = 0
    free_blocks: int = 0
    shared_on_target: int = 0
    bytes: int = 0
    d2h_bytes: int = 0
    d2h_time_s: float = 0.0
    deferred: int = 0              # handoffs gated by backpressure/capacity
    colocated_sticky: int = 0      # requests pinned to colocated decode

    def row(self) -> dict:
        d = dataclasses.asdict(self)
        d["d2h_time_s"] = round(self.d2h_time_s, 4)
        d["mean_latency_s"] = (round(self.d2h_time_s / self.migrations, 5)
                               if self.migrations else 0.0)
        return d


class MigrationEngine:
    """Executes and accounts KV handoffs between two DuplexKV instances.

    Stateless with respect to placement: callers decide *which* pair of
    replicas and *when*; ``migrate`` performs export → zero-copy handoff →
    import and returns the record (the caller moves the ``Request`` object
    and schedules its ROTARY re-entry at ``record.t_ready``).
    """

    def __init__(self):
        self.records: List[MigrationRecord] = []
        self.stats = MigrationStats()

    def can_migrate(self, req_id: int, src_kv: DuplexKV,
                    dst_kv: DuplexKV) -> bool:
        """Capacity gate: the export can demote and the import can land.
        (Backpressure — protecting the target's rotation H2D — is the
        cluster's policy on top of this.)"""
        n_blocks = len(src_kv.table.blocks_of(req_id))
        return (n_blocks > 0 and src_kv.can_export(req_id)
                and dst_kv.can_import(n_blocks))

    def migrate(self, req_id: int, src_kv: DuplexKV, dst_kv: DuplexKV,
                t: float) -> MigrationRecord:
        export: MigrationExport = src_kv.migrate_export(req_id)
        shared, _created = dst_kv.migrate_import(export)
        n = len(export.metas)
        rec = MigrationRecord(
            req_id=req_id, t_start=t, t_ready=t + export.stats.e2e_time,
            blocks=n, d2h_blocks=export.d2h_blocks,
            free_blocks=n - export.d2h_blocks, shared_on_target=shared,
            nbytes=export.nbytes, d2h_bytes=export.stats.d2h_bytes,
            d2h_time_s=export.stats.e2e_time)
        self.records.append(rec)
        s = self.stats
        s.migrations += 1
        s.blocks += rec.blocks
        s.d2h_blocks += rec.d2h_blocks
        s.free_blocks += rec.free_blocks
        s.shared_on_target += rec.shared_on_target
        s.bytes += rec.nbytes
        s.d2h_bytes += rec.d2h_bytes
        s.d2h_time_s += rec.d2h_time_s
        return rec
