"""Roofline terms of a step on an NVIDIA H100.

The port of ``src/repro/launch/roofline.py`` with the card's peaks in
place of TPU v5e's. Terms:

    compute    = FLOPs per device / PEAK_BF16_FLOPS
    memory     = bytes per device / HBM_BYTES_S
    collective = collective bytes per device / (NVLINK_BYTES_S / 2)

``model_flops`` ("useful" FLOPs of a step) and ``analytic_memory_bytes``
(the first-principles HBM traffic model) are the reference's formulas,
unchanged. The reference reads its FLOPs and collective bytes from the
compiled HLO; the port has no HLO: its FLOPs come from
``torch.utils.flop_counter.FlopCounterMode`` plus the hand-written
kernels' own formulas (``kernels/*.py::flops_and_bytes``). Its collective
bytes are what a run's collectives counted (``distributed/spmd.py``:
``collective_bytes``, per position, the reference's result-shape
convention), over ``Peaks.link_bw``: 0 on one device, counted on a mesh
that ran (``inspect_hlo --mesh``, ``chip_smoke.py`` phase 15), and on the
dry-run's production meshes counted by running the step over meta
positions (``launch/dryrun.py::collective_costs``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig, ShapeConfig

# NVIDIA H100 SXM data sheet, dense rates (no sparsity), at the 700 W limit
PEAK_BF16_FLOPS = 989e12          # tensor-core bf16, FLOP/s
HBM_BYTES_S = 3.35e12             # HBM3, bytes/s
# NVLink 4: 900 GB/s is the sum of both directions. The collective term
# counts each payload byte once, as the bytes one device receives (the
# reference's result-shape convention), so it divides by one direction's
# rate, NVLINK_BYTES_S / 2 = 450 GB/s.
NVLINK_BYTES_S = 900e9

@dataclasses.dataclass(frozen=True)
class Peaks:
    """A device's peak rates: bf16 FLOP/s, memory bytes/s, and the
    one-direction link bytes/s the collective term divides by."""
    name: str
    flops_bf16: float
    hbm_bw: float
    link_bw: float


H100_SXM = Peaks("h100-sxm", PEAK_BF16_FLOPS, HBM_BYTES_S,
                 NVLINK_BYTES_S / 2)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """'Useful' FLOPs per step: 6·N_active·D (train) / 2·N_active·D (fwd)
    + exact-causal attention term (and window/SSD variants)."""
    B, S = shape.global_batch, shape.seq_len
    n_act = cfg.active_param_count()
    # embedding params don't do matmul work per token; subtract lookups
    n_matmul = n_act - cfg.vocab_size * cfg.d_model  # keep lm_head, drop embed
    attn = 0.0
    for i in range(cfg.num_layers):
        if cfg.layer_kind(i) != "attn":
            # SSD: intra-chunk ~ 2*S*Q*(H*P) for y_diag + 2*S*Q*N for cb
            if cfg.ssm is not None:
                Q = cfg.ssm.chunk_size
                d_in = cfg.ssm.expand * cfg.d_model
                N = cfg.ssm.state_dim
                if shape.kind == "decode":
                    attn += 2 * B * d_in * N * 2
                else:
                    attn += 2 * B * S * Q * (d_in + N) / 2 + 4 * B * S * d_in * N
            continue
        eff = S if (cfg.layer_is_global(i) or not cfg.attn.sliding_window) \
            else min(cfg.attn.sliding_window, S)
        hq = cfg.num_heads * cfg.head_dim
        if shape.kind == "decode":
            attn += 4 * B * eff * hq          # QK + AV over cache
        else:
            attn += 4 * B * S * eff * hq / 2  # causal half
    if shape.kind == "decode":
        tok = B
        fwd = 2 * n_matmul * tok + attn
        return fwd
    tok = B * S
    fwd = 2 * n_matmul * tok + attn
    if shape.kind == "train":
        return 3 * fwd
    return fwd


def analytic_memory_bytes(cfg: ModelConfig, shape: ShapeConfig, *,
                          weights_local: float, opt_local: float,
                          cache_local: float, data_shards: int,
                          model_shards: int, fsdp_shards: int,
                          microbatches: int = 1,
                          flash_chunk_q: int = 512) -> Dict[str, float]:
    """First-principles per-device HBM traffic model (bytes/step).

    - decode: local weights read once (2D weight-stationary: no gathering;
      MoE experts scaled by routed-activity), full local KV/state read,
      logits write.
    - prefill: per-layer FSDP weight all-gather (write + read the gathered
      copy), ~12 activation streams per layer, flash K/V re-streamed once
      per Q-chunk, KV cache write.
    - train: 3 passes (fwd, remat-fwd, bwd) of gathered weights per
      microbatch, activation streams, gradient accumulation read+write,
      optimizer state read+write.
    """
    B, S = shape.global_batch, shape.seq_len
    d = cfg.d_model
    L = cfg.num_layers + cfg.num_encoder_layers
    bpe = 2  # bf16
    out: Dict[str, float] = {}
    if shape.kind == "decode":
        act = 1.0
        if cfg.moe is not None:
            # fraction of local expert weights touched by routed tokens
            tokens = B * cfg.moe.top_k
            act_moe = min(1.0, tokens / cfg.moe.num_experts)
            moe_frac = 1 - cfg.active_param_count() / cfg.param_count()
            # weights_local includes all experts; scale the expert part
            act = (1 - moe_frac) + moe_frac * act_moe
        out["weights"] = weights_local * act
        out["kv"] = cache_local
        out["logits"] = B * cfg.vocab_size / model_shards * 4
    elif shape.kind == "prefill":
        b_loc = max(B // data_shards, 1)
        gathered = weights_local * fsdp_shards
        out["weights"] = 2 * gathered
        out["activations"] = 12 * L * b_loc * S * d * bpe
        nq = max(S // flash_chunk_q, 1)
        kv_layer = b_loc * S * cfg.num_kv_heads * cfg.head_dim * 2 * bpe
        out["flash_kv_restream"] = cfg.num_attn_layers * nq * kv_layer / model_shards
        out["kv_write"] = cache_local
        out["logits"] = b_loc * cfg.vocab_size / model_shards * (2 + 4)
    else:  # train
        b_loc = max(B // data_shards, 1)
        b_mb = max(b_loc // microbatches, 1)
        gathered = weights_local * fsdp_shards
        out["weights"] = microbatches * 3 * 2 * gathered
        out["activations"] = microbatches * 14 * L * b_mb * S * d * bpe
        nq = max(S // flash_chunk_q, 1)
        kv_layer = b_mb * S * cfg.num_kv_heads * cfg.head_dim * 2 * bpe
        out["flash_kv_restream"] = (3 * microbatches * cfg.num_attn_layers
                                    * nq * kv_layer / model_shards)
        grad_local = weights_local * 2  # fp32 accum buffer r+w
        out["grads"] = microbatches * 2 * grad_local
        out["optimizer"] = 2 * opt_local + 2 * weights_local
        out["logits"] = microbatches * b_mb * S * cfg.vocab_size / model_shards * (2 + 4)
    out["total"] = sum(out.values())
    return out


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   coll_bytes_per_dev: Optional[float],
                   hw: Peaks = H100_SXM) -> Dict[str, object]:
    """Seconds each term takes at the peaks, the binding one and the
    step's lower bound; an unknown collective term (None) stays None and
    does not bind."""
    compute = flops_per_dev / hw.flops_bf16
    memory = bytes_per_dev / hw.hbm_bw
    collective = (None if coll_bytes_per_dev is None
                  else coll_bytes_per_dev / hw.link_bw)
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    known = {k: v for k, v in terms.items() if v is not None}
    dom = max(known, key=known.get)
    terms["bottleneck"] = dom.replace("_s", "")
    terms["step_s_lower_bound"] = max(known.values())
    return terms


def summarize(cfg: ModelConfig, shape: ShapeConfig, num_devices: int,
              cost: Optional[dict], coll: Optional[Dict[str, int]],
              memory_model: Optional[Dict[str, float]] = None,
              hw: Peaks = H100_SXM) -> Dict:
    """The roofline record of one step. ``cost``: {"flops": per device}
    (and "bytes accessed" where measured); ``coll``: collective bytes per
    device by kind (``spmd.collective_bytes()`` of a run, or the
    dry-run's count), or None where nothing counted them: the term is
    then unknown and does not bind."""
    flops_dev = float(cost.get("flops", 0.0)) if cost else 0.0
    raw_bytes_dev = float(cost.get("bytes accessed", 0.0)) if cost else 0.0
    bytes_dev = (memory_model or {}).get("total", raw_bytes_dev)
    coll_dev = (None if coll is None else
                float(sum(v for k, v in coll.items()
                          if not k.endswith("_count"))))
    mf = model_flops(cfg, shape)
    terms = roofline_terms(flops_dev, bytes_dev, coll_dev, hw)
    ideal_s = mf / (num_devices * hw.flops_bf16)
    achieved = terms["step_s_lower_bound"]
    # hardware-roofline fraction: the memory term already models the
    # irreducible traffic (weights and state read once), so the binding
    # roofline is max(ideal compute, intrinsic memory); the fraction is how
    # close the achieved lower bound sits to that binding roof
    intrinsic = max(ideal_s, terms["memory_s"])
    out = {
        "roofline_fraction_hw": (intrinsic / achieved) if achieved else 0.0,
        "flops_per_device": flops_dev,
        "memory_bytes_per_device": bytes_dev,
        "memory_model": memory_model,
        "bytes_accessed_per_device_raw": raw_bytes_dev,
        "collective_bytes_per_device": coll_dev,
        "collective_detail": coll,
        "model_flops_global": mf,
        "useful_flops_ratio": (mf / (flops_dev * num_devices)
                               if flops_dev else 0.0),
        "ideal_step_s": ideal_s,
        "roofline_fraction": (ideal_s / achieved) if achieved else 0.0,
        "peaks": dataclasses.asdict(hw),
        **terms,
    }
    return out
