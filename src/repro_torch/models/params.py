"""Weights of the dense ``LM`` (``models/lm.py``) and the paged runner.

The tree is ``{"layers": [per-layer dict, ...], "head": dict}`` in
execution order, plus ``"encoder": [per-layer dict, ...]`` for an
encoder-decoder config. A layer holds ``ln1``, then its mixer's weights
(attention: ``wq (d, H, D)``, ``wk``/``wv (d, Hkv, D)``, ``wo (H, D, d)``;
SSM: the projections, conv taps and ``A_log``/``D``/``dt_bias`` of
``_ssm_shapes``), then for a decoder layer of an encoder-decoder config
``ln_cross`` and ``cwq``/``cwk``/``cwv``/``cwo``, then ``ln2`` and its FFN
(dense: ``w_gate``/``w_up (d, f)``, ``w_down (f, d)``; MoE: a nested
``moe`` dict of ``router (d, E)``, ``w_gate``/``w_up (E, d, f)`` and
``w_down (E, f, d)``). The head holds ``embed (V, d)``, ``final_norm``,
``lm_head (d, V)`` unless the embeddings are tied, ``frontend_proj (e, d)``
for a frontend and ``enc_norm`` for an encoder. These are the shapes,
names and init rules of the reference's ``layer_param_defs``
(``src/repro/models/blocks.py:46-106``) and ``LM.param_defs``
(``lm.py:84-101``), in the same order, with the logical axes of its
``ParamDef``s (``param_axes``), which the dry-run lays over a mesh.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.blocks import LayerSpec, make_layer_spec
from repro_torch.models.common import dtype_of
from repro_torch.optimizer.adamw import TensorSpec


def _attn_shapes(cfg: ModelConfig, prefix: str = "") -> Dict[str, tuple]:
    d, H, Hkv, D = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {prefix + "wq": ((d, H, D), "normal", ("fsdp", "heads", None)),
            prefix + "wk": ((d, Hkv, D), "normal",
                            ("fsdp", "kv_heads", None)),
            prefix + "wv": ((d, Hkv, D), "normal",
                            ("fsdp", "kv_heads", None)),
            prefix + "wo": ((H, D, d), "normal", ("heads", None, "fsdp"))}


def _ssm_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    d, s = cfg.d_model, cfg.ssm
    d_in = s.expand * d
    H, N, W = d_in // s.head_dim, s.state_dim, s.conv_width
    return {"w_z": ((d, d_in), "normal", ("fsdp", "mlp")),
            "w_x": ((d, d_in), "normal", ("fsdp", "mlp")),
            "w_b": ((d, N), "normal", ("fsdp", None)),
            "w_c": ((d, N), "normal", ("fsdp", None)),
            "w_dt": ((d, H), "normal", ("fsdp", "ssm_heads")),
            "dt_bias": ((H,), "ssm_dt", ("ssm_heads",)),
            "A_log": ((H,), "ssm_a", ("ssm_heads",)),
            "D": ((H,), "ones", ("ssm_heads",)),
            "conv_x": ((W, d_in), "normal", (None, "mlp")),
            "conv_b": ((W, N), "normal", (None, None)),
            "conv_c": ((W, N), "normal", (None, None)),
            "norm_y": ((d_in,), "zeros", ("mlp",)),
            "out_proj": ((d_in, d), "normal", ("mlp", "fsdp"))}


def layer_shapes(cfg: ModelConfig, spec: LayerSpec) -> Dict[str, object]:
    """One layer's weights: name -> (shape, init, logical axes), the MoE
    weights nested under ``moe``. Init is "normal" (scaled by
    1/sqrt(shape[0]), the reference's fan-in axis, experts included),
    "zeros" (the norms, which scale by 1 + w), "ones", "ssm_a" or
    "ssm_dt". The logical axes are the reference's ``ParamDef``s'
    (``distributed/sharding.py`` maps them to mesh axes)."""
    d = cfg.d_model
    norm = ((d,), "zeros", (None,))
    out: Dict[str, object] = {"ln1": norm}
    out.update(_attn_shapes(cfg) if spec.mixer == "attn" else _ssm_shapes(cfg))
    if spec.has_cross:
        out["ln_cross"] = norm
        out.update(_attn_shapes(cfg, "c"))
    if spec.ffn != "none":
        out["ln2"] = norm
    if spec.ffn == "dense":
        f = cfg.d_ff
        out.update(w_gate=((d, f), "normal", ("fsdp", "mlp")),
                   w_up=((d, f), "normal", ("fsdp", "mlp")),
                   w_down=((f, d), "normal", ("mlp", "fsdp")))
    elif spec.ffn == "moe":
        m = cfg.moe
        E, f = m.num_experts, m.expert_d_ff or cfg.d_ff
        out["moe"] = {"router": ((d, E), "normal", ("fsdp", None)),
                      "w_gate": ((E, d, f), "normal",
                                 ("experts", "fsdp", None)),
                      "w_up": ((E, d, f), "normal",
                               ("experts", "fsdp", None)),
                      "w_down": ((E, f, d), "normal",
                                 ("experts", None, "fsdp"))}
    return out


def head_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    d = cfg.d_model
    out = {"embed": ((cfg.vocab_size, d), "normal", ("vocab", "fsdp")),
           "final_norm": ((d,), "zeros", (None,))}
    if not cfg.tie_embeddings:
        out["lm_head"] = ((d, cfg.vocab_size), "normal", ("fsdp", "vocab"))
    if cfg.frontend.kind != "none":
        out["frontend_proj"] = ((cfg.frontend.embed_dim, d), "normal",
                                (None, "fsdp"))
    if cfg.num_encoder_layers:
        out["enc_norm"] = ((d,), "zeros", (None,))
    return out


def param_shapes(cfg: ModelConfig):
    """(layer shapes, head shapes) of a uniform decoder, the paged
    runner's: every layer is layer 0's kind."""
    return layer_shapes(cfg, make_layer_spec(cfg, 0)), head_shapes(cfg)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device, dtype: torch.dtype, place=None) -> Dict[str, object]:
    """Random weights drawn from ``generator`` (which must live on
    ``device``), layer by layer in execution order, then the head, then the
    encoder; each tensor drawn in fp32 and cast to ``dtype`` at once, so
    one fp32 temporary lives at a time. ``place(tensor, logical_axes)``,
    where given, takes each tensor as soon as it is drawn (a mesh's
    placement), so one whole tensor lives on ``device`` at a time. The
    draws are torch's, not the JAX package's: to compare with the
    reference, bridge its weights with ``from_jax_lm_params``."""
    def draw(shape, init, axes):
        w = fill(shape, init)
        return w if place is None else place(w, axes)

    def fill(shape, init):
        if init in ("zeros", "ones"):
            fill = torch.zeros if init == "zeros" else torch.ones
            return fill(shape, dtype=dtype, device=device)
        if init in ("ssm_a", "ssm_dt"):
            lo, hi = (1.0, 16.0) if init == "ssm_a" else (1e-3, 1e-1)
            u = torch.rand(shape, generator=generator, device=device,
                           dtype=torch.float32) * (hi - lo) + lo
            # A_log: log U[1, 16]; dt_bias: inverse softplus of U[1e-3, 0.1]
            w = (torch.log(u) if init == "ssm_a"
                 else u + torch.log(-torch.expm1(-u)))
            return w.to(dtype)
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return w.mul_(1.0 / np.sqrt(max(shape[0], 1))).to(dtype)

    return _map_shapes(cfg, draw)


def _map_shapes(cfg: ModelConfig, fn) -> Dict[str, object]:
    """The weight tree with ``fn(shape, init, axes)`` at each leaf, built
    layer by layer in execution order, then the head, then the encoder."""
    def tree(shapes):
        return {k: tree(v) if isinstance(v, dict) else fn(*v)
                for k, v in shapes.items()}

    out = {"layers": [tree(layer_shapes(cfg, make_layer_spec(cfg, i)))
                      for i in range(cfg.num_layers)],
           "head": tree(head_shapes(cfg))}
    if cfg.num_encoder_layers:
        enc = layer_shapes(cfg, make_layer_spec(cfg, 0, decoder=False))
        out["encoder"] = [tree(enc) for _ in range(cfg.num_encoder_layers)]
    return out


def param_specs(cfg: ModelConfig) -> Dict[str, object]:
    """The weight tree of ``init_lm_params`` with ``TensorSpec(shape,
    dtype)`` leaves, allocating nothing."""
    dt = dtype_of(cfg.dtype)
    return _map_shapes(cfg, lambda shape, _i, _a: TensorSpec(tuple(shape),
                                                             dt))


def param_axes(cfg: ModelConfig) -> Dict[str, object]:
    """The weight tree of ``param_specs`` with ``(logical axes, shape)``
    leaves, the reference's ``param_logical_axes`` leaf for leaf (its
    segments stack each leaf under a leading None axis; here every layer
    holds its own)."""
    return _map_shapes(cfg, lambda shape, _, axes: (tuple(axes),
                                                    tuple(shape)))


def params_to(tree, device):
    """A copy of a weight (or cache) tree with every tensor on ``device``."""
    if isinstance(tree, Mapping):
        return {k: params_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to(v, device) for v in tree]
    return tree.to(device)


def _bridge(tree, device, dtype):
    if isinstance(tree, Mapping):
        return {k: _bridge(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_bridge(v, device, dtype) for v in tree]
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(
        device=device, dtype=dtype)


def from_jax_params(layers: Sequence[Mapping[str, object]],
                    head: Mapping[str, object], device,
                    dtype: torch.dtype) -> Dict[str, object]:
    """The weight bridge: the reference runner's per-layer dicts in
    execution order (``PagedModelRunner._layers``) and its head dict, as
    anything ``numpy.asarray`` reads, to the port's tree on ``device``."""
    return _bridge({"layers": list(layers), "head": dict(head)}, device,
                   dtype)


def init_lm_params(cfg: ModelConfig, generator: torch.Generator,
                   device, place=None) -> Dict[str, object]:
    """Weights of the dense ``LM`` at ``cfg.dtype``, drawn from
    ``generator`` exactly as ``init_params`` draws the paged runner's: one
    seed gives both executors the same model."""
    return init_params(cfg, generator, device, dtype_of(cfg.dtype), place)


def layers_of_segments(program, segments) -> List[dict]:
    """Per-layer dicts in execution order from a tree laid out by the
    reference's segments (segment -> repeat -> pattern position), as its
    ``LM.init`` weights and its ``LM.prefill`` caches are: a segment that
    repeats holds each leaf (nested dicts included) stacked on a leading
    axis of ``repeat``."""
    def pick(v, rep):
        if isinstance(v, Mapping):
            return {k: pick(x, rep) for k, x in v.items()}
        return v[rep]

    out = []
    for seg, p_seg in zip(program, segments, strict=True):
        for rep in range(seg.repeat):
            for pi in range(len(seg.pattern)):
                out.append(pick(p_seg[pi], rep) if seg.repeat > 1
                           else dict(p_seg[pi]))
    return out


def from_jax_lm_params(tree: Mapping[str, object], cfg: ModelConfig,
                       device) -> Dict[str, object]:
    """The weight bridge for the dense ``LM``: the reference ``LM.init``
    tree (``embed``, ``final_norm``, ``lm_head`` unless tied,
    ``frontend_proj``, ``segments`` with their nested ``moe`` dicts, and
    ``encoder`` with ``enc_norm``) to the port's per-layer tree on
    ``device``, at ``cfg.dtype``."""
    from repro_torch.models.lm import LM
    lm = LM(cfg)
    out = {"layers": layers_of_segments(lm.program, tree["segments"]),
           "head": {k: tree[k] for k in head_shapes(cfg)}}
    if lm.enc_program:
        out["encoder"] = layers_of_segments(lm.enc_program, tree["encoder"])
    return _bridge(out, device, dtype_of(cfg.dtype))
