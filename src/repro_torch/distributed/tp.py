"""Tensor-parallel sharding plan and shard operations for the paged runner.

The port of ``src/repro/distributed/tp.py`` (DESIGN.md §Tensor-parallel
execution). One logical replica spans the ``tp`` shards of a 1-D
``("model",)`` mesh (``launch.mesh.make_tp_mesh``).
The pooled block-first KV buffer shards its *kv-head* dim (pool row shape
``(L, 2, P, Hkv/TP, D)`` per shard) while block-table slot ids stay
GLOBAL (the row dim is never sharded), so DuplexKV, RotaSched and the
prefix cache are untouched by TP. Weights: q/kv heads and ``d_ff`` over
"model", everything else replicated.

GQA constrains the head split: q heads group per kv head, so a contiguous
head shard aligns with kv-head groups only when ``tp`` divides
``num_kv_heads``. When ``tp > num_kv_heads`` the plan falls back to
REPLICATED attention (q/k/v/wo and the KV pool on every shard) with only
the MLP sharded: validated, never silent.

Specs are the port's ``PSpec`` tuples (``distributed/sharding.py``: one
entry per dim, trailing Nones dropped). Where the reference's
``shard_map`` sliced the operands and ``psum`` added the partials, the
engine here is one controller that places each weight once at load time
(``spmd.place_spec``) and all-reduces over "model" after ``wo`` and
``w_down`` (``spmd.all_reduce``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.distributed.sharding import PSpec


@dataclasses.dataclass(frozen=True)
class TPPlan:
    """How one logical replica splits over the ``model`` mesh axis."""
    tp: int                 # mesh size (devices per replica)
    shard_kv: bool          # KV pool + q/k/v/wo sharded by kv heads
    shard_mlp: bool         # w_gate/w_up/w_down sharded on d_ff
    kv_shards: int          # pool shards actually holding distinct KV
    #                         (== tp when shard_kv, else 1: replicated pool)

    @property
    def trivial(self) -> bool:
        return self.tp == 1


def plan_tp_sharding(cfg, tp: int) -> TPPlan:
    """Validate a TP degree against a ModelConfig and return the plan.

    Raises ``ValueError`` naming the offending config field on invalid
    combinations (the GQA divisibility contract of DESIGN.md):

    * ``tp <= num_kv_heads``: requires ``num_kv_heads % tp == 0`` AND
      ``num_heads % tp == 0`` — each shard owns whole kv-head groups.
    * ``tp > num_kv_heads``: replicate-fallback — attention replicated,
      only the MLP shards; requires ``d_ff % tp == 0``.
    """
    tp = int(tp)
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if tp == 1:
        return TPPlan(tp=1, shard_kv=False, shard_mlp=False, kv_shards=1)
    if cfg.num_attn_layers == 0:
        raise ValueError(
            f"tensor parallelism needs attention layers to shard; "
            f"{cfg.name} (family={cfg.family}) has num_attn_layers == 0")
    hkv, h = cfg.num_kv_heads, cfg.num_heads
    if tp <= hkv:
        # attention constraints first: they name the decisive field (d_ff
        # of real checkpoints often shares no small factors with tp either)
        if hkv % tp != 0:
            raise ValueError(
                f"num_kv_heads={hkv} of {cfg.name} is not divisible by "
                f"tp={tp}; the KV pool shards whole kv heads over the "
                f"model axis — pick tp dividing num_kv_heads, or tp > "
                f"num_kv_heads for the replicated-attention fallback "
                f"(config field: num_kv_heads)")
        if h % tp != 0:
            raise ValueError(
                f"num_heads={h} of {cfg.name} is not divisible by tp={tp} "
                f"(config field: num_heads)")
        if cfg.d_ff % tp != 0:
            raise ValueError(
                f"d_ff={cfg.d_ff} of {cfg.name} is not divisible by "
                f"tp={tp}; the MLP shards its d_ff dim over the model axis "
                f"(config field: d_ff)")
        return TPPlan(tp=tp, shard_kv=True, shard_mlp=True, kv_shards=tp)
    if cfg.d_ff % tp != 0:
        raise ValueError(
            f"d_ff={cfg.d_ff} of {cfg.name} is not divisible by tp={tp}; "
            f"the replicated-attention fallback (tp > num_kv_heads={hkv}) "
            f"shards only the MLP's d_ff dim (config field: d_ff)")
    # tp > Hkv: a contiguous q-head shard would split kv-head groups across
    # shards, so attention replicates entirely (the validated fallback) and
    # only the MLP takes the tp-way split.
    return TPPlan(tp=tp, shard_kv=False, shard_mlp=True, kv_shards=1)


# --------------------------------------------------------------------------
# Partition specs (the port's PSpec tuples)
# --------------------------------------------------------------------------

def pool_pspec(plan: TPPlan) -> PSpec:
    """Spec of the pooled KV buffer ``(rows, L, 2, P, Hkv, D)``: the row dim
    (the block table's GLOBAL slot ids) is never sharded; only Hkv is."""
    return (None, None, None, None, "model") if plan.shard_kv else ()


def scale_pspec(plan: TPPlan) -> PSpec:
    """Spec of the quantized pool's scale tensor ``(rows, L, 2, Hkv)``: the
    per-(block, layer, side, head) scales shard along the kv-head dim with
    the pool — the quantization reduction axes (P, D) are never sharded, so
    per-shard scales are exact, not approximations."""
    return (None, None, None, "model") if plan.shard_kv else ()


def layer_pspecs(plan: TPPlan) -> dict:
    """Per-layer weight specs (keys of the paged runner's layer dicts)."""
    attn = plan.shard_kv
    mlp = plan.shard_mlp
    return {
        "ln1": (), "ln2": (),
        "wq": (None, "model") if attn else (),     # (d, H, hd)
        "wk": (None, "model") if attn else (),     # (d, Hkv, hd)
        "wv": (None, "model") if attn else (),
        "wo": ("model",) if attn else (),          # (H, hd, d)
        "w_gate": (None, "model") if mlp else (),  # (d, f)
        "w_up": (None, "model") if mlp else (),
        "w_down": ("model",) if mlp else (),       # (f, d)
    }


def head_pspecs(head: dict) -> dict:
    """Embedding / final norm / lm_head stay replicated: decode batches are
    tiny next to the layer stack, and a replicated head keeps the argmax
    bit-identical to the single-device runner."""
    return {k: () for k in head}
