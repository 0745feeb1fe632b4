"""Virtual Lag Time (paper §4.2.2) — the scheduling currency of RotaSched.

    VLT = α·ReLU(t_now − t_last − β_B·S_B)   rotary   (S_B = TBT SLO)
        = ReLU(t_now − t_arr − β_F·S_F)      waiting  (S_F = TTFT SLO)
        = −(t_now − t_run)                   running
"""
from __future__ import annotations

from repro_torch.configs.base import RotaSchedConfig
from repro_torch.core.types import Request, RequestState


def vlt(req: Request, t_now: float, cfg: RotaSchedConfig) -> float:
    if req.state in (RequestState.ROTARY, RequestState.SWAPPING_OUT,
                     RequestState.SWAPPING_IN):
        t_last = req.t_last_token if req.t_last_token is not None else req.arrival_time
        return cfg.alpha * max(0.0, t_now - t_last - cfg.beta_b * req.slo.tbt_s)
    if req.state == RequestState.WAITING:
        return max(0.0, t_now - req.arrival_time - cfg.beta_f * req.slo.ttft_s)
    if req.state == RequestState.RUNNING:
        t_run = req.t_run_start if req.t_run_start is not None else t_now
        return -(t_now - t_run)
    return float("-inf")  # finished: never scheduled
