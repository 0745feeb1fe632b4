"""A benchmark root with one tiny cell, for the CPU tests: a copy of the
benchmark's metric readers, a tiny configuration (``qwen2.5-32b`` as the
port reduces it for CPU tests: 4 layers, d 64, 4/2 heads of 16, vocab 256),
a short chat mix and the cell's limits."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

CONFIG = {"registry_id": "qwen2.5-32b-tiny",
          "num_hidden_layers": 4, "hidden_size": 64,
          "num_attention_heads": 4, "num_key_value_heads": 2,
          "head_dim": 16, "intermediate_size": 128, "vocab_size": 256,
          "rope_theta": 1000000.0, "rms_norm_eps": 1e-06,
          "tie_word_embeddings": False, "torch_dtype": "bfloat16"}
TRAFFIC = {"lengths": {"in_mu": 3.5, "in_sigma": 0.5, "in_min": 8,
                       "in_max": 96, "out_mu": 2.5, "out_sigma": 0.5,
                       "out_min": 4, "out_max": 24},
           "arrival": "poisson", "rate_rps": 8.0, "warm_s": 1.0,
           "set_seed": 5, "slo_mix": {"interactive": 0.5, "standard": 0.5},
           "slo_ttft_s": {"interactive": 1.0, "standard": 5.0,
                          "batch": 30.0},
           "serving": {"block_size": 16, "prefill_chunk": 32,
                       "scheduler": "rotasched", "kv_dtype": "bf16",
                       "num_hbm_blocks": 24, "num_dram_blocks": 256,
                       "max_batch_size": 64, "max_model_len": 512}}
# the limit of the tiny cell's check, between the sound runs' widest gap
# and the fp8 control's on the same seeds (test_portbench_check.py)
CHECK = {"gap_limit": 0.05, "check_tokens": 64, "check_tokens_min": 16,
         "check_positions": 2000, "rotated_back_min": 0}
WORKLOAD = "tiny.chat"


def patch_registry(mp) -> None:
    """Let the harness find the tiny configuration's ``registry_id``: the
    port's CPU-test reduction of ``qwen2.5-32b``."""
    from portbench import harness
    from repro_torch.configs.base import get_config
    real = harness.registry_config
    mp.setattr(harness, "registry_config", lambda arch: (
        get_config("qwen2.5-32b").reduced() if arch == CONFIG["registry_id"]
        else real(arch)))


def make(root: Path, extra_metric: str = "") -> Path:
    """Lay the tiny cell out under ``root``; with ``extra_metric``, also a
    per-layer metric of that name whose reader is a new file."""
    pb = root / "portbench"
    shutil.copytree(HERE / "metrics", pb / "metrics")
    for sub, name, data in (("configs", "tiny", CONFIG),
                            ("traffic", "tiny", TRAFFIC),
                            ("cells", WORKLOAD, CHECK)):
        (pb / sub).mkdir(parents=True, exist_ok=True)
        (pb / sub / f"{name}.json").write_text(json.dumps(data))
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny", "source": "test",
                         "file": "portbench/configs/tiny.json",
                         "reduced": [], "why": "test"}]
    bench["workloads"] = [{"name": WORKLOAD, "config": "tiny",
                           "traffic": "tiny", "chips": 1, "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m["workloads"] = [WORKLOAD]
    if extra_metric:
        (pb / "metrics" / f"{extra_metric}.py").write_text(
            "def read(rec):\n    return float(len(rec.counted()))\n")
        bench["per_layer"].append({
            "name": f"{extra_metric}.tok", "unit": "req",
            "better": "higher", "source": "host_clock", "layer": "test",
            "moves": "output_tok_s", "workloads": [WORKLOAD]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
