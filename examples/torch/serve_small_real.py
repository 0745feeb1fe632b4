"""End-to-end serving with the PyTorch port: batched requests served by
the engine (RotaSched scheduling + DuplexKV block table) with real model
execution (a reduced llama3-8b in fp32 generates every token through
``RealExecutor``; rotations copy each request's caches off the device and
back). The port of ``examples/serve_small_real.py``.

Proves losslessness: the token streams with 16 HBM blocks, where the
engine must rotate, equal those with 4096, where it never does.

    PYTHONPATH=src python examples/torch/serve_small_real.py
    (runs on the CUDA card, or pass --device cpu)
"""
import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import numpy as np  # noqa: E402

from repro_torch.configs import GH200, ServingConfig, get_config  # noqa: E402
from repro_torch.core.types import Request  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.executor import RealExecutor  # noqa: E402


def make_requests(n, cfg, seed=0):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(8, 16))
        reqs.append(Request(
            req_id=i, arrival_time=0.0,
            prompt_len=plen, output_len=int(rng.integers(12, 20)),
            prompt_ids=[int(x) for x in rng.integers(1, cfg.vocab_size,
                                                     plen)]))
    return reqs


def run(num_hbm_blocks, label, cfg, device):
    sv = ServingConfig(num_hbm_blocks=num_hbm_blocks, num_dram_blocks=512,
                       scheduler="rotasched", block_size=4, max_model_len=64)
    real = RealExecutor(cfg, seed=42, device=device)
    eng = ServingEngine(cfg, sv, GH200, real_executor=real)
    reqs = make_requests(8, cfg, seed=3)
    # online API: half the requests submitted up front, the rest arrive
    # mid-run while the engine keeps stepping (rotation must stay
    # lossless across the admission seam too)
    for r in reqs[:4]:
        eng.add_request(r)
    for _ in range(3):
        eng.step()
    for r in reqs[4:]:
        eng.add_request(r)
    rep = eng.drain()
    streams = {r.req_id: list(r.generated_ids) for r in reqs}
    rotations = eng.stats.active_rotations + eng.stats.passive_preemptions
    print(f"[{label}] rotations={rotations} "
          f"ttft_att={rep.ttft_attainment:.2f} iters={eng.stats.iterations}")
    return streams, rotations


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' to run there)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(),
                              dtype="float32")
    print(f"{cfg.name}: {cfg.param_count() / 1e6:.2f}M params on {device}")
    ample, _ = run(4096, "ample memory (no rotation)", cfg, device)
    tight, rotations = run(16, "tight memory (forced rotation)", cfg, device)
    assert rotations > 0, "16 HBM blocks forced no rotation"
    assert ample == tight, "rotation changed generated tokens!"
    print("token streams identical under rotation — DuplexKV is lossless ✓")
    for rid in sorted(ample)[:3]:
        print(f"  req {rid}: {ample[rid]}")
    return ample


if __name__ == "__main__":
    main()
