"""The decoder LM: a program of layer segments, run layer by layer.

The port of ``src/repro/models/lm.py`` for decoder-only configs. The
program keeps the reference's segments (a pattern of layer specs and its
repeat count: sextets for gemma3's 5:1 local:global, plain stacks for
uniform models), which is also how the reference stacks its weights; the
reference's ``lax.scan`` over a segment becomes a Python loop over the
layers in program order, and the weights are one dict per layer
(``models/params.py``). Encoder-decoder configs and frontends are ROADMAP.md
§1 item 7d and raise; ``train_loss`` waits for item 9.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks
from repro_torch.models.blocks import LayerSpec, make_layer_spec
from repro_torch.models.common import rms_norm


@dataclasses.dataclass(frozen=True)
class Segment:
    pattern: Tuple[LayerSpec, ...]
    repeat: int


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


def build_program(cfg: ModelConfig) -> List[Segment]:
    """The decoder's layers as segments: the shortest period after which
    the layer pattern repeats (attention/SSM interleave, MoE period,
    local/global period), repeated, plus a tail."""
    n = cfg.num_layers
    period = 1
    if cfg.ssm is not None and cfg.attn.attn_period > 1:
        period = _lcm(period, cfg.attn.attn_period)
    if cfg.moe is not None:
        period = _lcm(period, cfg.moe.period)
    if cfg.attn.global_period:
        period = _lcm(period, cfg.attn.global_period)
    period = min(period, n)
    specs = [make_layer_spec(cfg, i) for i in range(n)]
    segments = []
    full = n // period
    if full:
        segments.append(Segment(tuple(specs[:period]), full))
    rem = n % period
    if rem:
        # by periodicity, layers [full*period:] match spec positions [0:rem]
        segments.append(Segment(tuple(specs[full * period:]), 1))
    return segments


class LM:
    """Functional decoder-only model over the weight tree ``{"layers":
    [per-layer dict, ...], "head": {"embed", "final_norm"[, "lm_head"]}}``.

    ``prefill`` returns one cache dict per layer (``k``/``v``, a ring of
    ``sliding_window`` slots on local layers); ``decode_step`` updates those
    caches in place.
    """

    def __init__(self, cfg: ModelConfig):
        if cfg.num_encoder_layers:
            raise NotImplementedError(
                "encoder-decoder LMs are not ported yet "
                "(ROADMAP.md §1 item 7d)")
        if cfg.frontend.kind != "none":
            raise NotImplementedError(
                f"the {cfg.frontend.kind!r} frontend is not ported yet "
                "(ROADMAP.md §1 item 7d)")
        self.cfg = cfg
        self.program = build_program(cfg)
        self.specs: List[LayerSpec] = [
            sp for seg in self.program for _ in range(seg.repeat)
            for sp in seg.pattern]
        for sp in self.specs:
            blocks.check_ported(sp)

    def _logits(self, params, h: torch.Tensor) -> torch.Tensor:
        head = params["head"]
        h = rms_norm(h, head["final_norm"], self.cfg.rms_eps)
        if self.cfg.tie_embeddings:
            return h @ head["embed"].T
        return h @ head["lm_head"]

    @torch.no_grad()
    def prefill(self, params, batch: Dict[str, torch.Tensor], capacity: int):
        """batch: tokens (B, S). Returns (last_logits (B, V), caches)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = params["head"]["embed"][tokens]                  # (B, S, d)
        B, S = tokens.shape
        positions = torch.arange(S, device=x.device).expand(B, S)
        caches = []
        for spec, p in zip(self.specs, params["layers"], strict=True):
            x, c = blocks.apply_layer_seq(cfg, spec, p, x, positions,
                                          capacity=capacity)
            caches.append(c)
        return self._logits(params, x[:, -1]), caches

    @torch.no_grad()
    def decode_step(self, params, caches, batch):
        """batch: token (B,), cache_len int. Returns (logits (B, V), caches);
        the caches are updated in place."""
        x = params["head"]["embed"][batch["token"]]          # (B, d)
        new_caches = []
        for spec, p, c in zip(self.specs, params["layers"], caches,
                               strict=True):
            x, nc = blocks.apply_layer_decode(self.cfg, spec, p, x, c,
                                              batch["cache_len"])
            new_caches.append(nc)
        return self._logits(params, x), new_caches
