"""The paper's headline in miniature: SLO attainment for SuperInfer
(RotaSched+DuplexKV) vs vLLM-style FCFS vs LTR under memory contention
(simulated GH200 timing around the real scheduling stack).

The port of ``examples/serve_slo_comparison.py``: the host layer on the
GH200 model's clock; nothing is placed on a device.

Requests are fed through the **online API** (engine.add_request while the
engine steps) — the same path the multi-replica router uses; pass
``--replicas 2`` to serve the same trace behind the SLO-aware router.

    PYTHONPATH=src python examples/torch/serve_slo_comparison.py [--rps 22]
    PYTHONPATH=src python examples/torch/serve_slo_comparison.py --replicas 2
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

from repro_torch.configs import (GH200, ServingConfig,  # noqa: E402
                                 get_config)
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.router import Router  # noqa: E402
from repro_torch.serving.workload import generate_requests  # noqa: E402


def serve_online(cfg, sv, reqs, replicas):
    """Feed the trace through the online add_request/step API."""
    if replicas > 1:
        router = Router(cfg, sv, GH200, replicas=replicas, policy="slo-aware")
        rep = router.run(reqs)
        return rep, router.aggregate_stats()
    eng = ServingEngine(cfg, sv, GH200)
    for r in sorted(reqs, key=lambda r: r.arrival_time):
        eng.submit(r)                      # trace replay: no event buffers
    rep = eng.drain()
    return rep, eng.stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rps", type=float, default=22.0)
    ap.add_argument("--duration", type=float, default=30.0)
    ap.add_argument("--replicas", type=int, default=1)
    args = ap.parse_args(argv)

    cfg = get_config("qwen2.5-32b")
    print(f"{'system':12s} {'TTFT att':>9s} {'TBT att':>9s} {'p99 TTFT':>9s} "
          f"{'p99 TBT':>9s} {'tok/s':>7s} {'rotations':>9s}")
    for sched in ("fcfs", "ltr", "lightllm", "rotasched"):
        sv = ServingConfig(num_hbm_blocks=4000, num_dram_blocks=100000,
                           scheduler=sched)
        reqs = generate_requests("sharegpt", rps=args.rps,
                                 duration_s=args.duration, seed=1)
        rep, stats = serve_online(cfg, sv, reqs, args.replicas)
        name = "SuperInfer" if sched == "rotasched" else sched
        print(f"{name:12s} {rep.ttft_attainment:9.3f} {rep.tbt_attainment:9.3f} "
              f"{rep.p99_ttft:8.2f}s {rep.p99_tbt*1e3:7.0f}ms "
              f"{rep.throughput_tok_s:7.0f} "
              f"{stats.active_rotations + stats.passive_preemptions:9d}")


if __name__ == "__main__":
    main()
