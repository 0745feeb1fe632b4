"""RotaSched: Largest-VLT-First scheduling (paper Algorithm 1).

Faithful implementation of the four steps:
  ① contention check — HBM fits all waiting+rotary ⇒ FCFS fallback,
  ② sort all requests by VLT descending,
  ③ admit waiting/rotary requests with VLT ≥ 0 from the head within the
     B_HBM + B_xfer block budget,
  ④ preempt running requests from the tail (VLT < 0) until the extra
     B_swap = B_xfer − B_left blocks are covered.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from repro_torch.configs.base import RotaSchedConfig
from repro_torch.core.blocktable import KVView
from repro_torch.core.types import Request, RequestState
from repro_torch.core.vlt import vlt


@dataclasses.dataclass
class ScheduleDecision:
    prioritized: List[Request]   # R: waiting/rotary to admit (swap-in/prefill)
    preempted: List[Request]     # P: running to rotate out
    fcfs_fallback: bool = False


def lvf_schedule(requests: Sequence[Request], *, t_now: float,
                 b_hbm_free: int, block_size: int,
                 cfg: RotaSchedConfig,
                 kv_view: Optional[KVView] = None) -> ScheduleDecision:
    """Paper Algorithm 1. ``requests`` = Q_R ∪ Q_W ∪ Q_S (any order).

    ``kv_view`` (prefix-cache mode) shrinks the block accounting by the
    cached share: admitting a request with cache-hit blocks only demands the
    uncached suffix; preempting a request only credits its exclusively held
    blocks (shared prefixes stay resident, so rotation frees less).
    """
    q_run = [r for r in requests if r.state == RequestState.RUNNING]
    q_wait = [r for r in requests if r.state == RequestState.WAITING]
    q_rot = [r for r in requests if r.state == RequestState.ROTARY]

    def blk(r: Request) -> int:
        need = r.blocks_needed(block_size)
        if kv_view is not None and r.state in (RequestState.WAITING,
                                               RequestState.ROTARY):
            need = max(need - kv_view.resident.get(r.req_id, 0), 0)
        return need

    def freeable(r: Request) -> int:
        """Blocks a preemption of ``r`` would actually release."""
        need = r.blocks_needed(block_size)
        if kv_view is not None:
            return min(need, kv_view.releasable.get(r.req_id, need))
        return need

    demand = sum(blk(r) for r in q_wait + q_rot)
    if b_hbm_free >= demand:                                   # step ①
        return ScheduleDecision(prioritized=list(q_wait + q_rot),
                                preempted=[], fcfs_fallback=True)

    pool = q_run + q_wait + q_rot
    vlts = {r.req_id: vlt(r, t_now, cfg) for r in pool}
    order = sorted(pool, key=lambda r: vlts[r.req_id], reverse=True)  # step ②

    # Step ③ with the VLT=0 boundary resolved per Fig. 8's narrative:
    # requests still *within tolerance* (VLT == 0) are not lagging — they may
    # fill FREE blocks (FCFS) but never trigger preemptive rotation. Only
    # strictly lagging requests (VLT > 0) spend the B_xfer rotation budget.
    # (Algorithm 1 as printed uses VLT >= 0, which under ReLU admits every
    # waiting/rotary request and rotates at full budget each iteration even
    # at equilibrium — see DESIGN.md §Faithfulness.)
    b_free = b_hbm_free
    b_left = cfg.b_xfer
    prioritized: List[Request] = []
    for r in order:
        if r.state not in (RequestState.WAITING, RequestState.ROTARY):
            continue
        v = vlts[r.req_id]
        need = blk(r)
        if v > 0 and need <= b_free + b_left:
            prioritized.append(r)
            take_free = min(need, b_free)
            b_free -= take_free
            b_left -= need - take_free
    for r in order:  # within-tolerance: free blocks only, FCFS by VLT order
        if r.state in (RequestState.WAITING, RequestState.ROTARY) \
                and vlts[r.req_id] == 0 and blk(r) <= b_free \
                and r not in prioritized:
            prioritized.append(r)
            b_free -= blk(r)

    # step ④: extra HBM blocks needed beyond what is currently free
    demand = sum(blk(r) for r in prioritized)
    b_swap = demand - b_hbm_free
    preempted: List[Request] = []
    for r in reversed(order):
        if b_swap <= 0:
            break
        if r.state == RequestState.RUNNING and vlts[r.req_id] < 0:
            preempted.append(r)
            b_swap -= freeable(r)

    return ScheduleDecision(prioritized=prioritized, preempted=preempted)
