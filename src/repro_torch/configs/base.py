"""Config system: model / shape / serving / hardware configs and the registry.

Every assigned architecture gets one ``configs/<id>.py`` defining a ``CONFIG``
ModelConfig with the exact published hyperparameters. Reduced configs for CPU
smoke tests come from ``ModelConfig.reduced()``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Model configs
# ---------------------------------------------------------------------------

Family = str  # "dense" | "moe" | "ssm" | "hybrid" | "encdec" | "vlm"


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    # MoE applies on layers where (layer_idx % period) == offset
    period: int = 1
    offset: int = 0
    capacity_factor: float = 1.25
    # d_ff of each expert (falls back to ModelConfig.d_ff when 0)
    expert_d_ff: int = 0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128        # N (SSD state size)
    head_dim: int = 64          # P (SSD head dim)
    expand: int = 2             # d_inner = expand * d_model
    chunk_size: int = 256       # SSD chunk length
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class AttentionPattern:
    """Which layers are attention and of which kind.

    kind per layer is derived:
      - hybrid (jamba): attention iff (layer_idx % attn_period) == attn_offset,
        else SSM.
      - local/global (gemma3): global iff ((layer_idx+1) % global_period)==0,
        else sliding-window local.
    """
    attn_period: int = 1        # 1 => every layer is attention
    attn_offset: int = 0
    sliding_window: int = 0     # 0 => full attention on local layers too
    global_period: int = 0      # 0 => no local/global split


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Modality frontend STUB (audio/vision): input_specs() provides precomputed
    frame/patch embeddings; no frontend weights are modeled beyond a projection."""
    kind: str = "none"          # "audio" | "vision" | "none"
    num_embeds: int = 0         # frames/patches per example
    embed_dim: int = 0          # raw embedding dim before projection


# element widths for the dtypes model configs declare (``ModelConfig.dtype``)
DTYPE_BYTES = {"bfloat16": 2, "bf16": 2, "float16": 2, "fp16": 2,
               "float32": 4, "fp32": 4, "int8": 1}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                    # 0 => d_model // num_heads
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    attn: AttentionPattern = AttentionPattern()
    frontend: FrontendConfig = FrontendConfig()
    # encoder-decoder
    num_encoder_layers: int = 0          # >0 => enc-dec; num_layers = decoder layers
    cross_attention: bool = False
    rope_theta: float = 1e4
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    max_position: int = 131072
    source: str = ""                     # provenance tag

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # -- derived ------------------------------------------------------------
    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def layer_kind(self, i: int) -> str:
        """'attn' | 'ssm' for mixer of layer i (decoder stack)."""
        if self.family == "ssm":
            return "ssm"
        if self.ssm is not None and self.attn.attn_period > 1:
            return "attn" if (i % self.attn.attn_period) == self.attn.attn_offset else "ssm"
        return "attn"

    def layer_is_global(self, i: int) -> bool:
        """Local/global attention split (gemma3-style)."""
        if self.attn.global_period <= 0:
            return True
        return ((i + 1) % self.attn.global_period) == 0

    def layer_is_moe(self, i: int) -> bool:
        if self.moe is None:
            return False
        return (i % self.moe.period) == self.moe.offset

    @property
    def num_attn_layers(self) -> int:
        return sum(1 for i in range(self.num_layers) if self.layer_kind(i) == "attn")

    @property
    def num_ssm_layers(self) -> int:
        return sum(1 for i in range(self.num_layers) if self.layer_kind(i) == "ssm")

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + per-layer), for rooflines."""
        d, h, kv, hd, f, v = (self.d_model, self.num_heads, self.num_kv_heads,
                              self.head_dim, self.d_ff, self.vocab_size)
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d  # lm head
        dec_layers = 0
        for i in range(self.num_layers):
            p = 2 * d  # norms
            if self.layer_kind(i) == "attn":
                p += d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d
            else:
                s = self.ssm
                d_in = s.expand * d
                nheads = d_in // s.head_dim
                # in_proj produces [z, x, B, C, dt]
                p += d * (2 * d_in + 2 * s.state_dim + nheads)
                p += d_in * d  # out_proj
                p += s.conv_width * (d_in + 2 * s.state_dim)  # conv
                p += 2 * nheads  # A_log, D
            if self.layer_is_moe(i):
                m = self.moe
                eff = m.expert_d_ff or f
                p += m.num_experts * 3 * d * eff + d * m.num_experts  # experts + router
            elif self.layer_kind(i) == "attn" or self.family == "ssm":
                if f > 0 and self.family != "ssm":
                    p += 3 * d * f  # gate/up/down
            dec_layers += p
        total += dec_layers
        # encoder stack (same width; encoder has no KV sharing subtleties)
        if self.num_encoder_layers:
            enc = self.num_encoder_layers * (2 * d + d * (h * hd) + 2 * d * (kv * hd)
                                             + (h * hd) * d + 3 * d * f)
            total += enc
            if self.cross_attention:
                total += self.num_layers * (d * (h * hd) + 2 * d * (kv * hd)
                                            + (h * hd) * d + d)
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        eff = m.expert_d_ff or self.d_ff
        inactive_per_moe_layer = (m.num_experts - m.top_k) * 3 * self.d_model * eff
        n_moe = sum(1 for i in range(self.num_layers) if self.layer_is_moe(i))
        return self.param_count() - n_moe * inactive_per_moe_layer

    def dtype_bytes(self) -> int:
        """Width of one activation/KV element in the model's own dtype."""
        return DTYPE_BYTES[self.dtype]

    def kv_bytes_per_token(self, dtype_bytes: Optional[int] = None) -> int:
        """KV bytes one token pins across every attention layer. With no
        argument the element width derives from ``self.dtype`` (it used to
        silently assume 2 bytes even for fp32 reduced-model runs); pass
        ``dtype_bytes`` explicitly for a quantized cache tier (e.g. 1 for
        the int8 KV pool — scale-row overhead is per *block*, so it lives
        in ``duplexkv.block_bytes_of``, not here)."""
        if dtype_bytes is None:
            dtype_bytes = self.dtype_bytes()
        per_attn = 2 * self.num_kv_heads * self.head_dim * dtype_bytes
        return per_attn * self.num_attn_layers

    # -- reduced config for CPU smoke tests ----------------------------------
    def reduced(self) -> "ModelConfig":
        """Same family/structure, tiny dims: runnable on 1 CPU core."""
        scale = dict(
            num_layers=min(self.num_layers, 4),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            max_position=512,
        )
        kw = dataclasses.asdict(self)
        kw.update(scale)
        kw["name"] = self.name + "-reduced"
        if self.moe is not None:
            kw["moe"] = MoEConfig(num_experts=min(self.moe.num_experts, 4),
                                  top_k=min(self.moe.top_k, 2),
                                  period=self.moe.period, offset=self.moe.offset,
                                  capacity_factor=self.moe.capacity_factor,
                                  expert_d_ff=64 if self.moe.expert_d_ff else 0)
        else:
            kw["moe"] = None
        if self.ssm is not None:
            kw["ssm"] = SSMConfig(state_dim=16, head_dim=8, expand=2, chunk_size=16,
                                  conv_width=self.ssm.conv_width)
        else:
            kw["ssm"] = None
        kw["attn"] = AttentionPattern(
            attn_period=self.attn.attn_period, attn_offset=self.attn.attn_offset,
            sliding_window=min(self.attn.sliding_window, 32) if self.attn.sliding_window else 0,
            global_period=self.attn.global_period)
        if self.frontend.kind != "none":
            kw["frontend"] = FrontendConfig(kind=self.frontend.kind, num_embeds=8,
                                            embed_dim=32)
        else:
            kw["frontend"] = FrontendConfig()
        if self.num_encoder_layers:
            kw["num_encoder_layers"] = min(self.num_encoder_layers, 2)
        return ModelConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                              for k, v in kw.items()})


# ---------------------------------------------------------------------------
# Input shapes (the assigned 4-shape set)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k":    ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k":  ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k":   ShapeConfig("long_500k", 524288, 1, "decode"),
}

# long_500k only runs for sub-quadratic archs (SSM / hybrid / sliding-window).
LONG_CONTEXT_ARCHS = ("mamba2-2.7b", "jamba-1.5-large-398b", "gemma3-1b")


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    if shape.name == "long_500k" and cfg.name not in LONG_CONTEXT_ARCHS:
        return False, "pure full-attention arch: 500k decode is quadratic-KV; skipped per DESIGN.md"
    return True, ""


# ---------------------------------------------------------------------------
# Hardware profiles
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LinkProfile:
    """Host<->device link: bandwidth as a function of segment size + launch cost.

    ``bw_table`` is a piecewise log-linear (bytes -> B/s) curve calibrated to
    the paper's Fig. 5/12 measurements (per-segment effective bandwidth,
    including per-launch overheads). A *batched* launch (cudaMemcpyBatchAsync
    analogue) moves the whole descriptor set as one stream at the curve's
    large-transfer rate. Concurrent bidirectional transfers are capped by
    ``duplex_total_bw`` (Grace DRAM is half-duplex: ~384 GB/s total).
    """
    bw_table: Tuple[Tuple[int, float], ...]   # sorted (bytes, B/s)
    duplex_total_bw: float                    # B/s, cap on D2H+H2D combined
    dram_total_bw: float                      # theoretical DRAM limit (Ideal)
    launch_us: float                          # fixed cost per copy launch

    @property
    def peak_bw(self) -> float:
        return self.bw_table[-1][1]

    def effective_bw(self, segment_bytes: int) -> float:
        """Per-segment effective uni-directional bandwidth (log-interp)."""
        import math as _m
        t = self.bw_table
        b = max(int(segment_bytes), 1)
        if b <= t[0][0]:
            # below first point: launch-bound, rate ∝ size
            return max(t[0][1] * b / t[0][0], 1.0)
        if b >= t[-1][0]:
            return t[-1][1]
        for (x0, y0), (x1, y1) in zip(t, t[1:]):
            if x0 <= b <= x1:
                f = (_m.log(b) - _m.log(x0)) / (_m.log(x1) - _m.log(x0))
                return y0 + f * (y1 - y0)
        return t[-1][1]


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    name: str
    flops_bf16: float           # per chip
    hbm_bw: float               # per chip
    hbm_bytes: int
    dram_bytes: int             # host tier per chip
    link: LinkProfile
    ici_bw: float = 50e9        # per link, inter-chip
    mfu: float = 0.55           # assumed achievable fraction for the sim cost model


# GH200 link table calibrated to the paper's Table 1 / Fig. 5 / Fig. 12:
#   naive 64KB-segment copies -> ~10.3 GB/s (launch-bound),
#   4MB block-first segments -> ~100 GB/s (MS row),
#   batched-kernel stream -> 254 GB/s uni-directional (MS+MK row),
#   full-duplex capped by Grace DRAM: 342 GB/s achieved, 384 GB/s ideal.
GH200 = HardwareProfile(
    name="gh200",
    flops_bf16=989e12, hbm_bw=4000e9, hbm_bytes=144 << 30, dram_bytes=480 << 30,
    link=LinkProfile(
        bw_table=((64 << 10, 10.3e9), (256 << 10, 28e9), (1 << 20, 55e9),
                  (4 << 20, 100e9), (8 << 20, 160e9), (16 << 20, 210e9),
                  (64 << 20, 254e9)),
        duplex_total_bw=342e9, dram_total_bw=384e9, launch_us=6.0),
)

H200_PCIE = HardwareProfile(
    name="h200-pcie",
    flops_bf16=989e12, hbm_bw=4800e9, hbm_bytes=141 << 30, dram_bytes=480 << 30,
    link=LinkProfile(
        bw_table=((64 << 10, 9e9), (256 << 10, 22e9), (1 << 20, 38e9),
                  (4 << 20, 50e9), (16 << 20, 55e9)),
        duplex_total_bw=110e9, dram_total_bw=110e9, launch_us=6.0),
)

TPU_V5E = HardwareProfile(
    name="tpu-v5e",
    flops_bf16=197e12, hbm_bw=819e9, hbm_bytes=16 << 30, dram_bytes=128 << 30,
    link=LinkProfile(
        bw_table=((64 << 10, 6e9), (256 << 10, 16e9), (1 << 20, 32e9),
                  (4 << 20, 52e9), (16 << 20, 64e9)),
        duplex_total_bw=100e9, dram_total_bw=110e9, launch_us=5.0),
)

HW_PROFILES = {p.name: p for p in (GH200, H200_PCIE, TPU_V5E)}


# ---------------------------------------------------------------------------
# Serving / scheduler configs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SLOConfig:
    ttft_s: float = 5.0     # S_F
    tbt_s: float = 0.100    # S_B


@dataclasses.dataclass(frozen=True)
class RotaSchedConfig:
    alpha: float = 3.0
    beta_b: float = 0.0
    beta_f: float = 0.5
    b_xfer: int = 2400          # blocks per iteration transfer budget


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    block_size: int = 16                  # tokens per KV block (P)
    num_hbm_blocks: int = 4096
    num_dram_blocks: int = 65536
    max_batch_size: int = 256
    prefill_chunk: int = 512              # chunked-prefill token budget (Sarathi)
    scheduler: str = "rotasched"          # see serving/schedulers.py registry
    slo: SLOConfig = SLOConfig()
    rotary: RotaSchedConfig = RotaSchedConfig()
    auto_b_xfer: bool = True              # size B_xfer to hide under exec
    eager_rotation: bool = True
    block_first_layout: bool = True
    batched_transfer_kernel: bool = True
    duplex: bool = True
    pipeline_overlap: bool = True         # within-iteration exec/transfer max
    # Cross-iteration two-stage pipeline: while iteration N's kernels
    # execute, iteration N+1 is planned and its transfers staged — the
    # per-direction duplex channels persist ACROSS iterations and compute
    # serializes only on true row dependencies (promotion reads, swap-in
    # rows feeding the next batch). Default off: the synchronous path is
    # bit-identical to the golden replay. See DESIGN.md §Pipelined execution.
    pipeline: bool = False
    max_model_len: int = 8192
    # Two-tier prefix cache (ref-counted, content-addressed KV blocks with
    # DRAM-tier demotion through DuplexKV). Default off: replay bit-identical
    # to the exclusive-ownership engine. See DESIGN.md §Two-tier prefix cache.
    prefix_cache: bool = False
    # PagedModelRunner: batched REAL execution over a pooled block-first KV
    # cache addressed by the engine's block table (paged-attention
    # decode + kv_copy rotation; composes with prefix_cache). Default off:
    # the executor stays the pure timing model and replay is bit-identical.
    # See DESIGN.md §Execution layer.
    paged_runner: bool = False
    # Tensor-parallel degree of ONE logical replica: the KV pool shards its
    # kv-head dim over a ("model",) mesh of tp devices, weights follow
    # DECODE_RULES, and transfer accounting turns per-shard (each Superchip
    # moves 1/tp of every row, concurrently). tp=1 (default) is the
    # single-chip path, bit-identical to the golden replay. GQA requires
    # num_kv_heads % tp == 0 (or tp > num_kv_heads for the validated
    # replicated-attention fallback). See DESIGN.md §Tensor-parallel
    # execution.
    tp: int = 1
    # KV cache storage dtype. "bf16" (default) stores KV in the model's own
    # dtype — bit-identical to the golden replay. "int8" stores a blockwise
    # -quantized pool: int8 values with one fp32 scale per (block, layer,
    # K/V, kv-head), halving bytes-per-block, so admission fits ~2x blocks
    # per HBM budget and every rotation/migration leg moves ~half the bytes
    # (quality guarded by tolerance tests, not bit-parity). See DESIGN.md
    # §Quantized KV tier.
    kv_dtype: str = "bf16"
    # Flight recorder: bounded ring-buffer telemetry bus on every EngineCore
    # (request lifecycle spans + per-iteration engine events, sim-clock
    # stamped; exported as a Perfetto trace). Default off: no bus is
    # allocated and the step loop takes the exact golden-replay code path.
    # See DESIGN.md §Observability.
    telemetry: bool = False
    telemetry_buffer: int = 65536         # ring capacity (spans and events each)

    def __post_init__(self):
        if self.kv_dtype not in ("bf16", "int8"):
            raise ValueError(
                f"kv_dtype must be 'bf16' or 'int8', got {self.kv_dtype!r}")


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCH_IDS = (
    "jamba-1.5-large-398b",
    "seamless-m4t-medium",
    "llama3-405b",
    "yi-34b",
    "mistral-large-123b",
    "gemma3-1b",
    "paligemma-3b",
    "dbrx-132b",
    "qwen3-moe-30b-a3b",
    "mamba2-2.7b",
)

# Paper's own evaluation models (for the benchmark harness)
PAPER_MODEL_IDS = ("llama3-8b", "qwen2.5-32b", "mixtral-8x7b")

_MODULE_FOR = {
    "jamba-1.5-large-398b": "jamba_1_5_large",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "llama3-405b": "llama3_405b",
    "yi-34b": "yi_34b",
    "mistral-large-123b": "mistral_large_123b",
    "gemma3-1b": "gemma3_1b",
    "paligemma-3b": "paligemma_3b",
    "dbrx-132b": "dbrx_132b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "mamba2-2.7b": "mamba2_2_7b",
    "llama3-8b": "llama3_8b",
    "qwen2.5-32b": "qwen2_5_32b",
    "mixtral-8x7b": "mixtral_8x7b",
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULE_FOR:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULE_FOR)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_FOR[arch_id]}")
    return mod.CONFIG


def all_arch_ids() -> Sequence[str]:
    return ARCH_IDS
