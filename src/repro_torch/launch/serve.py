"""Serving launcher: run the SuperInfer engine (simulated device timing
around the real scheduler/block-table/transfer stack) and print SLO metrics.
The port of ``src/repro/launch/serve.py``: the same flags and the same
report, plus ``--device``.

    PYTHONPATH=src python -m repro_torch.launch.serve --model qwen2.5-32b \
        --scheduler rotasched --rps 20 --duration 40

Multi-replica serving (each replica a full engine behind the router):

    PYTHONPATH=src python -m repro_torch.launch.serve --rps 20 \
        --duration 40 --replicas 2 --router slo-aware

Quantized KV tier, executed for real on the paged runner (int8 pool with
fused-dequant paged attention; on the CUDA card unless ``--device cpu``):

    PYTHONPATH=src python -m repro_torch.launch.serve --paged-runner \
        --kv-dtype int8 --hbm-blocks 96 --rps 5 --duration 5 --json

Disaggregated prefill/decode serving with cross-replica KV migration:

    PYTHONPATH=src python -m repro_torch.launch.serve --rps 30 \
        --duration 40 --arrival burst --disagg --json

Tensor parallelism: one replica over ``--tp`` shards. On the CPU every
shard is the CPU; on CUDA it needs ``--tp`` cards, unless ``--device``
lists the shards' devices, comma-separated (``cuda:0,cuda:0`` stacks two
shards on one card: it proves the sharded layout, not a TP speed-up):

    PYTHONPATH=src python -m repro_torch.launch.serve --tp 2 --device cpu \
        --rps 5 --duration 5 --json

``--paged-runner`` runs on CUDA unless ``--device cpu`` is given; with no
CUDA device and no ``--device cpu`` it fails rather than fall back.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.serving.telemetry import emit_json_report


def _devices(arg):
    """``--device``: one device, or a comma-separated list (one a shard)."""
    if arg is None or "," not in arg:
        return arg
    return [d.strip() for d in arg.split(",")]


def main(argv=None):
    # --tp is checked before anything is built: too few cards fail here
    # with the recipe (launch.hostenv), as the reference's check does
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--tp", type=int, default=1)
    pre.add_argument("--device", default=None)
    pre_args, _ = pre.parse_known_args(argv)
    if pre_args.tp > 1:
        from repro_torch.launch.hostenv import ensure_host_devices
        ensure_host_devices(pre_args.tp, _devices(pre_args.device))

    from repro_torch.serving.router import ROUTER_POLICIES

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="qwen2.5-32b")
    ap.add_argument("--scheduler", default="rotasched",
                    choices=["rotasched", "fcfs", "wf", "sf", "sjf", "ltr",
                             "lightllm"])
    ap.add_argument("--dataset", default="sharegpt",
                    choices=["sharegpt", "lmsys", "rag"])
    ap.add_argument("--rps", type=float, default=20.0)
    ap.add_argument("--duration", type=float, default=40.0)
    ap.add_argument("--hw", default="gh200",
                    choices=["gh200", "h200-pcie", "tpu-v5e"])
    ap.add_argument("--replicas", type=int, default=1,
                    help="number of engine replicas behind the router")
    ap.add_argument("--router", default="least-loaded",
                    choices=list(ROUTER_POLICIES),
                    help="routing policy (used when --replicas > 1)")
    ap.add_argument("--arrival", default="poisson",
                    choices=["poisson", "burst", "ramp"],
                    help="arrival pattern: stationary Poisson (default), "
                         "on/off bursts, or a linear ramp (mean rate stays "
                         "--rps for all three)")
    ap.add_argument("--burst-on", type=float, default=4.0,
                    help="burst window length in seconds (--arrival burst)")
    ap.add_argument("--burst-off", type=float, default=8.0,
                    help="lull length in seconds (--arrival burst)")
    ap.add_argument("--burst-factor", type=float, default=3.0,
                    help="rate multiplier inside burst windows")
    ap.add_argument("--disagg", action="store_true",
                    help="disaggregated prefill/decode serving: requests "
                         "prefill on a dedicated pool, then their KV "
                         "migrates to a decode pool through the DRAM tier "
                         "(overrides --replicas/--router)")
    ap.add_argument("--prefill-replicas", type=int, default=1,
                    help="prefill-pool size under --disagg")
    ap.add_argument("--decode-replicas", type=int, default=1,
                    help="decode-pool size under --disagg")
    ap.add_argument("--migration-watermark", type=int, default=2048,
                    metavar="BLOCKS",
                    help="per-decode-replica pending-swap-in backlog above "
                         "which migrations are deferred (keeps decode H2D "
                         "from starving rotation traffic)")
    ap.add_argument("--colocate-watermark", type=int, default=8192,
                    metavar="TOKENS",
                    help="prefill-pool queue depth above which new arrivals "
                         "prefill directly on the decode pool")
    ap.add_argument("--slo-mix", default=None, metavar="CLASS=FRAC,...",
                    help="heterogeneous SLO classes, e.g. "
                         "'interactive=0.3,standard=0.5,batch=0.2' "
                         "(default: homogeneous 'standard' tier)")
    ap.add_argument("--prefix-cache", choices=["on", "off"], default="off",
                    help="two-tier prefix cache: content-addressed, "
                         "ref-counted KV blocks with DRAM-tier demotion "
                         "(off = bit-identical legacy replay)")
    ap.add_argument("--prefix-share", type=float, default=None,
                    metavar="RATIO",
                    help="generate a shared-prefix trace with real prompt "
                         "token ids; RATIO of requests share one of "
                         "--prefix-count common prefixes")
    ap.add_argument("--prefix-len", type=int, default=256,
                    help="shared prefix length in tokens")
    ap.add_argument("--prefix-count", type=int, default=8,
                    help="number of distinct shared prefixes")
    ap.add_argument("--paged-runner", action="store_true",
                    help="execute tokens for REAL on a reduced model over "
                         "the pooled block-first KV cache (batched CUDA "
                         "paged-attention decode; rotation physically moves "
                         "pool rows). Timing stays calibrated to --model. "
                         "The trace is clamped to smoke scale (short "
                         "prompts/outputs, reduced vocab), as the reference "
                         "launcher clamps it.")
    ap.add_argument("--device", default=None,
                    help="where --paged-runner executes: CUDA unless "
                         "'cpu' is given (no CUDA device and no --device "
                         "cpu is an error, never a fallback); under --tp, "
                         "a comma-separated list of one device per shard")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor parallelism: shards of one replica")
    ap.add_argument("--paged-max-prompt", type=int, default=40,
                    help="prompt-length clamp under --paged-runner")
    ap.add_argument("--paged-max-output", type=int, default=8,
                    help="output-length clamp under --paged-runner")
    ap.add_argument("--kv-dtype", choices=["bf16", "int8"], default="bf16",
                    help="KV cache storage dtype. int8 selects the blockwise"
                         "-quantized tier: the paged pool stores int8 rows + "
                         "per-(block, layer, K/V, head) fp32 scales, paged "
                         "attention dequantizes in-kernel, and rotation / "
                         "migration over C2C move ~half the bytes per block "
                         "(bf16, the default, is the bit-identical path)")
    ap.add_argument("--hbm-blocks", type=int, default=4000)
    ap.add_argument("--hbm-budget-gb", type=float, default=None,
                    metavar="GB",
                    help="size the HBM tier by a KV byte budget instead of "
                         "--hbm-blocks: block count = budget // block_bytes "
                         "for the chosen --model / --kv-dtype (the capacity "
                         "comparison knob: the same budget holds ~2x blocks "
                         "under --kv-dtype int8)")
    ap.add_argument("--dram-blocks", type=int, default=100000)
    ap.add_argument("--alpha", type=float, default=3.0)
    ap.add_argument("--beta-b", type=float, default=0.0)
    ap.add_argument("--beta-f", type=float, default=0.5)
    ap.add_argument("--b-xfer", type=int, default=0, help="0 = auto")
    ap.add_argument("--no-duplex", action="store_true")
    ap.add_argument("--no-eager", action="store_true")
    ap.add_argument("--no-block-first", action="store_true")
    ap.add_argument("--no-pipeline", action="store_true")
    ap.add_argument("--pipeline", action="store_true",
                    help="cross-iteration two-stage pipeline: per-direction "
                         "transfer channels persist across iterations and "
                         "compute serializes only on true row dependencies "
                         "(token streams are identical to synchronous mode; "
                         "schedule_ms/transfer_ms/execute_ms/overlap_ms land "
                         "in the output)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--telemetry", action="store_true",
                    help="record the flight recorder (lifecycle spans + "
                    "per-iteration engine events; see DESIGN.md "
                    "§Observability)")
    ap.add_argument("--trace-out", metavar="PATH", default=None,
                    help="write a Perfetto/Chrome-trace JSON of the run "
                    "(implies --telemetry); open at https://ui.perfetto.dev")
    args = ap.parse_args(argv)
    if args.replicas < 1:
        ap.error("--replicas must be >= 1")
    device = _devices(args.device)

    from repro_torch.configs import HW_PROFILES, RotaSchedConfig, ServingConfig, get_config
    from repro_torch.serving.disagg import DisaggCluster
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.router import Router
    from repro_torch.serving.workload import (generate_mixed_requests,
                                        generate_requests,
                                        generate_shared_prefix_requests)

    cfg = get_config(args.model)
    rot = RotaSchedConfig(alpha=args.alpha, beta_b=args.beta_b,
                          beta_f=args.beta_f,
                          b_xfer=args.b_xfer if args.b_xfer else 2400)
    hbm_blocks = args.hbm_blocks
    if args.hbm_budget_gb is not None:
        from repro_torch.core.duplexkv import hbm_block_capacity
        hbm_blocks = hbm_block_capacity(
            cfg, ServingConfig.block_size,
            int(args.hbm_budget_gb * (1 << 30)), kv_dtype=args.kv_dtype)
    sv = ServingConfig(
        num_hbm_blocks=hbm_blocks, num_dram_blocks=args.dram_blocks,
        scheduler=args.scheduler, rotary=rot,
        auto_b_xfer=(args.b_xfer == 0),
        duplex=not args.no_duplex, eager_rotation=not args.no_eager,
        block_first_layout=not args.no_block_first,
        batched_transfer_kernel=not args.no_block_first,
        pipeline_overlap=not args.no_pipeline,
        pipeline=args.pipeline,
        prefix_cache=(args.prefix_cache == "on"),
        paged_runner=args.paged_runner, tp=args.tp,
        kv_dtype=args.kv_dtype,
        telemetry=bool(args.telemetry or args.trace_out))
    hw = HW_PROFILES[args.hw]
    arrival_kw = (dict(burst_on=args.burst_on, burst_off=args.burst_off,
                       burst_factor=args.burst_factor)
                  if args.arrival == "burst" else None)
    if args.prefix_share is not None:
        reqs = generate_shared_prefix_requests(
            args.dataset, args.rps, args.duration, seed=args.seed,
            share_ratio=args.prefix_share, prefix_len=args.prefix_len,
            n_prefixes=args.prefix_count, class_mix=args.slo_mix,
            arrival=args.arrival, arrival_kw=arrival_kw)
    elif args.slo_mix:
        reqs = generate_mixed_requests(args.dataset, args.rps, args.duration,
                                       seed=args.seed,
                                       class_mix=args.slo_mix,
                                       arrival=args.arrival,
                                       arrival_kw=arrival_kw)
    else:
        reqs = generate_requests(args.dataset, args.rps, args.duration,
                                 seed=args.seed, arrival=args.arrival,
                                 arrival_kw=arrival_kw)

    runner_cfg = None
    if args.paged_runner:
        import numpy as np
        # real execution: a reduced fp32 model; clamp the trace to
        # smoke scale and remap token ids into the reduced vocab (prompts
        # without ids get deterministic synthetic ones)
        runner_cfg = dataclasses.replace(cfg.reduced(), dtype="float32")
        rng = np.random.default_rng([args.seed, 0xBA9ED])
        for r in reqs:
            r.prompt_len = min(r.prompt_len, args.paged_max_prompt)
            r.output_len = min(r.output_len, args.paged_max_output)
            if r.sampling is not None:
                r.sampling = dataclasses.replace(
                    r.sampling, max_tokens=r.output_len)
            if r.prompt_ids is None:
                r.prompt_ids = [int(x) for x in rng.integers(
                    1, runner_cfg.vocab_size, r.prompt_len)]
            else:
                r.prompt_ids = [1 + (int(x) % (runner_cfg.vocab_size - 1))
                                for x in r.prompt_ids[:r.prompt_len]]

    if args.disagg:
        cluster = DisaggCluster(
            cfg, sv, hw, prefill_replicas=args.prefill_replicas,
            decode_replicas=args.decode_replicas,
            migration_watermark=args.migration_watermark,
            colocate_watermark=args.colocate_watermark,
            runner_cfg=runner_cfg, runner_seed=args.seed,
            device=device)
        rep = cluster.run(reqs)
        stats = cluster.aggregate_stats()
        cache_counters = cluster.aggregate_cache_counters()
    elif args.replicas > 1:
        router = Router(cfg, sv, hw, replicas=args.replicas,
                        policy=args.router, runner_cfg=runner_cfg,
                        runner_seed=args.seed, device=device)
        rep = router.run(reqs)
        stats = router.aggregate_stats()
        cache_counters = router.aggregate_cache_counters()
    else:
        eng = ServingEngine(cfg, sv, hw, runner_cfg=runner_cfg,
                            runner_seed=args.seed, device=device)
        rep = eng.run(reqs)
        stats = eng.stats
        cache_counters = eng.kv.cache_counters()
    row = rep.row()
    # one public name per metric: the CLI surface calls the report's
    # prefix_hit_rate "cache_hit_rate" (what CI/README bind to)
    row["cache_hit_rate"] = row.pop("prefix_hit_rate", rep.prefix_hit_rate)
    row.update(scheduler=args.scheduler, model=args.model, rps=args.rps,
               arrival=args.arrival,
               active_rotations=stats.active_rotations,
               passive_preemptions=stats.passive_preemptions,
               eager_blocks=stats.eager_blocks,
               aborted=stats.aborted,
               stall_time=round(stats.stall_time, 3),
               prefix_cache=args.prefix_cache,
               prefill_tokens_executed=stats.prefill_tokens,
               pipeline=args.pipeline)
    if args.disagg:
        cores = cluster.replicas
    elif args.replicas > 1:
        cores = router.replicas
    else:
        cores = [eng.core]
    # capacity + rotation byte accounting: what the quantized tier halves.
    # block_bytes is dtype-aware (int8 rows + per-block scales), and the
    # d2h/h2d byte counters are what the C2C link actually carried — the
    # CI int8 smoke asserts both against a bf16 run of the same budget
    tc = [c.kv.transfer_counters() for c in cores]
    row.update(kv_dtype=args.kv_dtype,
               hbm_blocks=hbm_blocks,
               block_bytes=cores[0].kv.block_bytes,
               d2h_bytes=sum(t["d2h_bytes"] for t in tc),
               h2d_bytes=sum(t["h2d_bytes"] for t in tc))
    if args.tp > 1:
        # per-shard link accounting: what ONE shard's link actually carried
        row.update(tp=args.tp, kv_shards=tc[0]["kv_shards"],
                   d2h_bytes_per_shard=sum(t["d2h_bytes_per_shard"]
                                           for t in tc),
                   h2d_bytes_per_shard=sum(t["h2d_bytes_per_shard"]
                                           for t in tc))
    if args.paged_runner:
        # per-replica executors: sum counters cluster-wide (replicas == 1
        # degenerates to the single engine's executor)
        execs = [c.executor for c in cores]
        if args.tp > 1:
            row.update(
                pool_shard_bytes=sum(e.store.pool_shard_bytes
                                     for e in execs),
                pool_global_bytes=sum(e.store.pool_global_bytes
                                      for e in execs))
        row.update(
            paged_runner=True,
            decode_batches=sum(e.decode_batches for e in execs),
            decode_tokens=sum(e.decode_tokens for e in execs),
            attn_launches=sum(e.attn_launches for e in execs),
            kv_copy_launches=sum(e.store.copy_launches for e in execs),
            kv_rows_moved=sum(e.store.d2h_rows + e.store.h2d_rows
                              + e.store.d2d_rows for e in execs),
            # host-side dispatch wall time (observability; sim clock is
            # still the timing authority)
            prefill_launch_wall_s=round(
                sum(e.prefill_launch_wall_s for e in execs), 6),
            decode_launch_wall_s=round(
                sum(e.decode_launch_wall_s for e in execs), 6),
            kv_copy_launch_wall_s=round(
                sum(e.store.copy_launch_wall_s
                    + e.store.upload_launch_wall_s for e in execs), 6))
    if sv.telemetry:
        from repro_torch.serving.telemetry import buses_of
        from repro_torch.serving.trace_export import write_trace
        buses = buses_of(cores)
        row.update(telemetry=dict(
            spans=sum(b.spans_recorded for b in buses),
            spans_dropped=sum(b.spans_dropped for b in buses),
            events=sum(b.events_recorded for b in buses),
            events_dropped=sum(b.events_dropped for b in buses)))
        if args.trace_out:
            write_trace(args.trace_out, cores)
            row.update(trace_out=args.trace_out)
    if args.prefix_cache == "on":
        row.update(cache_counters=cache_counters)
    if args.slo_mix:
        row.update(slo_mix=args.slo_mix)
    if args.disagg:
        pool_tokens = cluster.pool_token_counts()
        row.update(disagg=True, prefill_replicas=args.prefill_replicas,
                   decode_replicas=args.decode_replicas,
                   migration=cluster.migration_counters(),
                   prefill_pool_tokens=pool_tokens["prefill"],
                   decode_pool_tokens=pool_tokens["decode"])
    if not args.disagg and args.replicas > 1:
        row.update(replicas=args.replicas, router=args.router,
                   per_replica=[
                       dict(replica=p.idx, n=p.n_routed,
                            ttft_attainment=p.report.ttft_attainment,
                            p99_ttft=p.report.p99_ttft)
                       for p in router.per_replica_reports()])
    if args.json:
        # one JSON document on stdout (CI pipes this into json.load), via
        # the shared telemetry emitter
        emit_json_report(row)
    else:
        per_class = row.pop("per_class", {})
        for k, v in row.items():
            print(f"{k:22s} {v}")
        for name, c in per_class.items():
            print(f"  [{name:12s}] n={c['n']:4d} "
                  f"ttft_att={c['ttft_attainment']:.3f} "
                  f"tbt_att={c['tbt_attainment']:.3f} "
                  f"p99_ttft={c['p99_ttft']:.3f}")
        row["per_class"] = per_class
    return row


if __name__ == "__main__":
    main()
