"""Scheduler zoo: RotaSched (the paper) + the baselines it is evaluated
against (§3.1, §5.2).

Interface: ``schedule(reqs, t_now, hbm_free, block_size) -> Decision`` where
Decision lists requests to admit (waiting -> prefill, rotary -> swap-in) and
running requests to preempt. The engine enforces block-capacity feasibility;
schedulers express *policy*.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.configs.base import RotaSchedConfig
from repro_torch.core.blocktable import KVView
from repro_torch.core.rotasched import ScheduleDecision, lvf_schedule
from repro_torch.core.types import Request, RequestState


class Scheduler:
    name = "base"

    def schedule(self, reqs: Sequence[Request], t_now: float,
                 hbm_free: int, block_size: int,
                 b_xfer: Optional[int] = None,
                 kv_view: Optional[KVView] = None) -> ScheduleDecision:
        """``kv_view`` is the prefix-cache residency snapshot (None when
        the cache is off); only RotaSched's accounting consumes it — the
        baseline policies model systems without prefix reuse."""
        raise NotImplementedError


def _split(reqs):
    w = [r for r in reqs if r.state == RequestState.WAITING]
    s = [r for r in reqs if r.state == RequestState.ROTARY]
    run = [r for r in reqs if r.state == RequestState.RUNNING]
    return w, s, run


def _fit(cands: List[Request], budget: int, block_size: int) -> List[Request]:
    out = []
    for r in cands:
        need = r.blocks_needed(block_size)
        if need <= budget:
            out.append(r)
            budget -= need
    return out


class RotaSched(Scheduler):
    """The paper's LVF scheduler (core.rotasched). ``b_xfer`` may be set
    per-iteration by the engine (auto mode: the transfer budget the link can
    hide under model execution — the §4.2.3 co-design knob)."""
    name = "rotasched"

    def __init__(self, cfg: RotaSchedConfig):
        self.cfg = cfg

    def schedule(self, reqs, t_now, hbm_free, block_size, b_xfer=None,
                 kv_view=None):
        cfg = self.cfg if b_xfer is None else dataclasses.replace(
            self.cfg, b_xfer=b_xfer)
        return lvf_schedule(reqs, t_now=t_now, b_hbm_free=hbm_free,
                            block_size=block_size, cfg=cfg, kv_view=kv_view)


class FCFS(Scheduler):
    """vLLM baseline: passive preemption only; swapped requests go first in
    the candidate order but get no reservation — a waiting request that fits
    may take the blocks a larger swapped request is still short of."""
    name = "fcfs"

    def schedule(self, reqs, t_now, hbm_free, block_size, b_xfer=None,
                 kv_view=None):
        w, s, run = _split(reqs)
        cands = sorted(s, key=lambda r: r.arrival_time) \
            + sorted(w, key=lambda r: r.arrival_time)
        return ScheduleDecision(prioritized=_fit(cands, hbm_free, block_size),
                                preempted=[])


class WaitingFirst(Scheduler):
    """Static WF (§3.1): new arrivals preempt running requests."""
    name = "wf"

    def schedule(self, reqs, t_now, hbm_free, block_size, b_xfer=None,
                 kv_view=None):
        w, s, run = _split(reqs)
        w = sorted(w, key=lambda r: r.arrival_time)
        s = sorted(s, key=lambda r: r.arrival_time)
        admit = _fit(w + s, hbm_free, block_size)
        need = sum(r.blocks_needed(block_size) for r in w) - hbm_free
        preempt = []
        if need > 0:
            # preempt newest-running (LIFO, vLLM style) to make room for waiting
            for r in sorted(run, key=lambda r: r.arrival_time, reverse=True):
                if need <= 0:
                    break
                preempt.append(r)
                need -= r.blocks_needed(block_size)
            budget = hbm_free + sum(r.blocks_needed(block_size) for r in preempt)
            admit = _fit(w + s, budget, block_size)
        return ScheduleDecision(prioritized=admit, preempted=preempt)


class SwappedFirst(Scheduler):
    """Static SF (§3.1): rotary resumption has *absolute* priority. Unlike
    FCFS, swapped requests that do not fit block the waiting queue entirely
    (head-of-line reservation), so under contention free blocks accumulate
    for the swap-in instead of being grabbed by newer waiting arrivals —
    SF starves TTFT to protect TBT of rotated requests."""
    name = "sf"

    def schedule(self, reqs, t_now, hbm_free, block_size, b_xfer=None,
                 kv_view=None):
        w, s, run = _split(reqs)
        s_sorted = sorted(s, key=lambda r: r.arrival_time)
        admit = _fit(s_sorted, hbm_free, block_size)
        budget = hbm_free - sum(r.blocks_needed(block_size) for r in admit)
        if len(admit) == len(s_sorted):  # all swapped placed: leftover to W
            admit = admit + _fit(sorted(w, key=lambda r: r.arrival_time),
                                 budget, block_size)
        return ScheduleDecision(prioritized=admit, preempted=[])


class SJFOracle(Scheduler):
    """Shortest-Job-First with oracle output lengths (Appendix A)."""
    name = "sjf"

    def schedule(self, reqs, t_now, hbm_free, block_size, b_xfer=None,
                 kv_view=None):
        w, s, run = _split(reqs)
        cands = sorted(s + w, key=lambda r: r.output_len)
        return ScheduleDecision(prioritized=_fit(cands, hbm_free, block_size),
                                preempted=[])


class LTR(Scheduler):
    """Learning-to-rank (Fu et al. 2024) approximation: SJF on *predicted*
    lengths (multiplicative lognormal noise, seeded per request)."""
    name = "ltr"

    def __init__(self, noise_sigma: float = 0.4, seed: int = 0):
        self.noise_sigma = noise_sigma
        self.seed = seed
        self._pred: Dict[int, float] = {}

    def _predict(self, r: Request) -> float:
        if r.req_id not in self._pred:
            rng = np.random.default_rng((self.seed << 20) ^ r.req_id)
            self._pred[r.req_id] = r.output_len * float(
                rng.lognormal(0.0, self.noise_sigma))
        return self._pred[r.req_id]

    def schedule(self, reqs, t_now, hbm_free, block_size, b_xfer=None,
                 kv_view=None):
        w, s, run = _split(reqs)
        cands = sorted(s + w, key=self._predict)
        return ScheduleDecision(prioritized=_fit(cands, hbm_free, block_size),
                                preempted=[])


class LightLLMLike(Scheduler):
    """'Past-future' admission (Gong et al. 2025): admit a waiting request
    only if the *peak future* KV demand of running ∪ candidate fits HBM —
    avoids harmful evictions, stabilizes TBT, sacrifices TTFT under load."""
    name = "lightllm"

    def schedule(self, reqs, t_now, hbm_free, block_size, b_xfer=None,
                 kv_view=None):
        w, s, run = _split(reqs)
        # peak future demand of running set (oracle output lengths)
        def peak_blocks(r: Request) -> int:
            total = r.prompt_len + r.output_len
            return -(-total // block_size)

        current = sum(r.blocks_needed(block_size) for r in run)
        future_headroom = hbm_free + current \
            - sum(peak_blocks(r) for r in run)
        admit = []
        for r in sorted(s, key=lambda r: r.arrival_time) \
                + sorted(w, key=lambda r: r.arrival_time):
            if peak_blocks(r) <= future_headroom \
                    and r.blocks_needed(block_size) <= hbm_free:
                admit.append(r)
                future_headroom -= peak_blocks(r)
                hbm_free -= r.blocks_needed(block_size)
        return ScheduleDecision(prioritized=admit, preempted=[])


def make_scheduler(name: str, rotary_cfg: Optional[RotaSchedConfig] = None,
                   **kw) -> Scheduler:
    name = name.lower()
    if name == "rotasched":
        return RotaSched(rotary_cfg or RotaSchedConfig())
    return {"fcfs": FCFS, "wf": WaitingFirst, "sf": SwappedFirst,
            "sjf": SJFOracle, "ltr": LTR, "lightllm": LightLLMLike}[name](**kw)
