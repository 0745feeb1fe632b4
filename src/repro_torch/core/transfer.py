"""Link transfer-time model + the four engine modes of paper Table 1.

Modes:
  naive   — layer-first layout: each block is N_layers small segments, each
            issued as its own copy (vLLM behaviour);
  ms      — block-first layout (merged segments): one big segment per block,
            still one launch per segment;
  ms_mk   — + merged (batched) kernel: one launch per direction, the whole
            direction streams at the large-transfer rate; directions remain
            SERIALIZED (swap-in waits for swap-out: the data race);
  duplex  — + eager block rotation removed the race: both directions run
            concurrently, jointly capped by the host-DRAM bandwidth.

Timing is a discrete model over the calibrated ``LinkProfile`` bandwidth
curve (configs.base); validated against the paper's Table 1 in
benchmarks/bench_transfer_engine.py.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import HardwareProfile, LinkProfile
from repro_torch.core.blocktable import TransferDesc

MODES = ("naive", "ms", "ms_mk", "duplex")


@dataclasses.dataclass
class TransferStats:
    d2h_bytes: int = 0
    h2d_bytes: int = 0
    d2h_time: float = 0.0
    h2d_time: float = 0.0
    e2e_time: float = 0.0
    launches: int = 0
    # tensor-parallel accounting: the pool's kv-head dim is sharded over
    # ``shards`` Superchips, so each shard moves 1/shards of every row over
    # ITS OWN C2C link, concurrently — byte totals above stay GLOBAL, the
    # per-shard fields are what one link actually carried. shards == 1
    # (the default) keeps every field bit-identical to the single-chip path.
    shards: int = 1
    d2h_bytes_per_shard: int = 0
    h2d_bytes_per_shard: int = 0


class TransferEngine:
    def __init__(self, link: LinkProfile, mode: str = "duplex",
                 shards: int = 1):
        assert mode in MODES, mode
        assert shards >= 1, shards
        self.link = link
        self.mode = mode
        # KV-pool shards moving concurrently: each shard's link carries
        # nbytes/shards of every descriptor (C2C bandwidth is per-Superchip)
        self.shards = int(shards)

    # -- per-direction time ----------------------------------------------------
    def _direction_time(self, descs: Sequence[TransferDesc]) -> Tuple[float, int, int]:
        """Returns (seconds, launches, GLOBAL bytes) for one direction.
        With ``shards > 1`` the time is what ONE shard's link takes for its
        1/shards slice (all shards stream concurrently); launch counts are
        per shard (each shard issues its own batched launch)."""
        if not descs:
            return 0.0, 0, 0
        s = self.shards
        total = sum(d.nbytes for d in descs)
        if self.mode == "naive":
            # layer-first: every (layer, block) segment is its own launch
            t = 0.0
            n = 0
            for d in descs:
                seg = d.nbytes // max(d.segments, 1) // s
                t += d.segments * (seg / self.link.effective_bw(seg))
                n += d.segments
            return t, n, total
        if self.mode == "ms":
            # block-first merged segment, one launch per block
            t = sum((d.nbytes // s) / self.link.effective_bw(d.nbytes // s)
                    for d in descs)
            return t, len(descs), total
        # ms_mk / duplex: single batched launch per direction, streams at the
        # large-transfer rate
        stream_bw = self.link.effective_bw(max(total, descs[0].nbytes) // s)
        t = self.link.launch_us * 1e-6 + (total / s) / stream_bw
        return t, 1, total

    # -- both directions ---------------------------------------------------------
    def execute(self, d2h: Sequence[TransferDesc],
                h2d: Sequence[TransferDesc]) -> TransferStats:
        s = self.shards
        t_d2h, n1, b1 = self._direction_time(d2h)
        t_h2d, n2, b2 = self._direction_time(h2d)
        if self.mode == "duplex":
            # concurrent directions, jointly capped by host-DRAM bandwidth
            # (per Superchip — each shard has its own Grace DRAM)
            cap = self.link.duplex_total_bw / 2
            t_d2h = max(t_d2h, b1 / s / cap if b1 else 0.0)
            t_h2d = max(t_h2d, b2 / s / cap if b2 else 0.0)
            e2e = max(t_d2h, t_h2d)
        else:
            # data race on shared HBM slots serializes the directions
            e2e = t_d2h + t_h2d
        return TransferStats(d2h_bytes=b1, h2d_bytes=b2, d2h_time=t_d2h,
                             h2d_time=t_h2d, e2e_time=e2e, launches=n1 + n2,
                             shards=s, d2h_bytes_per_shard=b1 // s,
                             h2d_bytes_per_shard=b2 // s)

    def ideal_duplex_time(self, d2h_bytes: int, h2d_bytes: int) -> float:
        cap = (self.link.dram_total_bw / 2) * self.shards
        return max(d2h_bytes / cap if d2h_bytes else 0.0,
                   h2d_bytes / cap if h2d_bytes else 0.0)

    # effective blocks/s the engine can rotate (used to set B_xfer)
    def sustained_block_rate(self, block_bytes: int, segments: int) -> float:
        d = TransferDesc(0, 0, "d2h", 0, 0, block_bytes, segments)
        t, _, _ = self._direction_time([d] * 64)
        per_block = t / 64
        if self.mode == "duplex":
            per_block = max(per_block, (block_bytes / self.shards)
                            / (self.link.duplex_total_bw / 2))
        return 1.0 / per_block if per_block > 0 else float("inf")


@dataclasses.dataclass
class PipelineTimeline:
    """Per-direction transfer channels that persist ACROSS engine iterations
    (the cross-iteration pipeline, ``ServingConfig.pipeline``).

    The synchronous model charges each iteration ``max(exec, transfer)``
    independently: a transfer burst larger than one execution window stalls
    the iteration that issued it, even though a full-duplex link would keep
    streaming under the *following* iterations' compute. Here each direction
    is a channel with a busy-until frontier; an iteration's planned
    transfers occupy their channel from issue time (they were planned while
    the previous iteration executed), and model execution starts as soon as
    its true row dependencies allow:

      * ``exec_needs_h2d`` — the batch reads rows this iteration's H2D
        delivers (prefix-cache promotions feeding a prefill chunk);
      * ``h2d_after_d2h`` — an H2D destination slot is still being read by
        an in-flight D2H (slot reuse within the iteration): same-slot
        traffic serializes, full-duplex or not;
      * ``exec_needs_d2h`` — the batch WRITES a row an in-flight D2H is
        reading (never in correct operation — the hazard check in
        ``blocktable.guard_compute`` fires first — but the timeline stays
        conservative if a caller models it);
      * swap-ins resumed this iteration decode NEXT iteration, so the next
        ``advance`` may not start compute before their H2D landed
        (``dep_ready``).

    ``advance`` returns ``(exec_end, overlap_s, stall_s)``: the wall time
    the iteration's compute finishes (the engine's clock), the transfer
    seconds hidden under the compute window, and the seconds compute sat
    waiting on transfers (the visible stall).
    """
    d2h_free: float = 0.0      # D2H channel busy-until (wall time)
    h2d_free: float = 0.0      # H2D channel busy-until (wall time)
    dep_ready: float = 0.0     # earliest next compute start (row deps)
    # Absolute windows of the most recent ``advance`` call, for the flight
    # recorder: {"exec"|"d2h"|"h2d": (start, end)}. Pure side record — the
    # return contract and the channel frontiers are unchanged.
    last: Optional[Dict[str, Tuple[float, float]]] = None

    def advance(self, t: float, exec_s: float, d2h_s: float, h2d_s: float,
                *, exec_needs_h2d: bool = False, h2d_after_d2h: bool = False,
                exec_needs_d2h: bool = False, gates_next_exec: bool = False
                ) -> Tuple[float, float, float]:
        d2h_start = max(t, self.d2h_free)
        d2h_end = d2h_start + d2h_s
        if d2h_s > 0.0:
            self.d2h_free = d2h_end
        h2d_start = max(t, self.h2d_free)
        if h2d_after_d2h and h2d_s > 0.0 and d2h_s > 0.0:
            h2d_start = max(h2d_start, d2h_end)
        h2d_end = h2d_start + h2d_s
        if h2d_s > 0.0:
            self.h2d_free = h2d_end
        exec_start = max(t, self.dep_ready)
        if exec_needs_h2d and h2d_s > 0.0:
            exec_start = max(exec_start, h2d_end)
        if exec_needs_d2h and d2h_s > 0.0:
            exec_start = max(exec_start, d2h_end)
        exec_end = exec_start + exec_s
        if gates_next_exec and h2d_s > 0.0:
            self.dep_ready = max(self.dep_ready, h2d_end)
        # transfer seconds lying under this iteration's compute window
        overlap = 0.0
        if d2h_s > 0.0:
            overlap += max(0.0, min(d2h_end, exec_end)
                           - max(d2h_start, exec_start))
        if h2d_s > 0.0:
            overlap += max(0.0, min(h2d_end, exec_end)
                           - max(h2d_start, exec_start))
        stall = exec_start - t
        self.last = {"exec": (exec_start, exec_end),
                     "d2h": (d2h_start, d2h_end),
                     "h2d": (h2d_start, h2d_end)}
        return exec_end, overlap, stall


def engine_for_flags(hw: HardwareProfile, *, block_first: bool,
                     batched_kernel: bool, duplex: bool,
                     shards: int = 1) -> TransferEngine:
    """Map ServingConfig feature flags onto a Table-1 mode. ``shards`` is
    the KV-pool tensor-parallel degree (1 = single-chip, bit-identical to
    the pre-TP engine)."""
    if not block_first:
        mode = "naive"
    elif not batched_kernel:
        mode = "ms"
    elif not duplex:
        mode = "ms_mk"
    else:
        mode = "duplex"
    return TransferEngine(hw.link, mode, shards=shards)
