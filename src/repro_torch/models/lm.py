"""The LM: a program of layer segments, run layer by layer; encoder-decoder
configs and modality frontends.

The port of ``src/repro/models/lm.py`` at inference. The program keeps
the reference's segments (a pattern of layer specs and its repeat count:
jamba's period of eight for its 1:7 attention:SSM interleave with MoE on
odd layers, sextets for gemma3's 5:1 local:global, plain stacks for
uniform models), which is also how the reference stacks its weights; the
reference's ``lax.scan`` over a segment becomes a Python loop over the
layers in program order, and the weights are one dict per layer
(``models/params.py``). An encoder-decoder config encodes its source
embeddings with a non-causal stack that the decoder's cross-attention
reads; a decoder with a frontend puts its projected embeddings before the
tokens. ``train_loss`` is the training objective; with ``remat`` it runs
the decoder's layers in groups of ``remat_group`` under
``torch.utils.checkpoint``, the counterpart of the reference's
``jax.checkpoint`` and grouped remat. ``train_loss(..., mesh=...)`` runs
every family (dense, MoE, SSM, hybrid, encoder-decoder, frontend) over a
mesh of devices on weights laid out by ``distributed/spmd.py`` (each data
row of the mesh takes its share of the batch, its frontend embeddings or
its encoder's source frames; heads, SSM channels and heads, ``d_ff``,
experts and the vocabulary split over "model"; FSDP weights gathered over
"data" layer by layer inside the remat groups, so the gathered copies are
freed after each group and gathered again in its recompute; the groups
rematerialize through ``_Remat``, whose backward recomputes on one
thread, where ``torch.utils.checkpoint``'s hooks would run on every card's
autograd thread at once; the encoder runs without remat, as the
reference's, and each position's copy of its memory feeds that position's
cross-attention heads). ``prefill(..., mesh=)`` and
``decode_step(..., mesh=)`` run every family over such a mesh: the
prefill under ``PREFILL_RULES`` (each data row its share of the batch, of
its frontend embeddings or of its encoder's source frames, flash on each
position's q heads, the caches' sequence over "model"; an encoder's
memory first, each position's copy feeding its cross-attention, whose
keys and values become the cross caches), the decode under
``DECODE_RULES`` (weight-stationary: the residual stream split over
"data" along d and whole in batch, the caches' sequence over the whole
grid, the softmax merged across it; the cross caches read, never
written); ``caches_for_decode`` moves a prefill's caches to the decode
layout between the two. On the multi-pod mesh ("pod" ahead of "data"
and "model") a "data row" is a (pod, data) pair: the batch splits over
both together where they divide it (``batch_split``), the weights are
whole across pods, and each pod runs the same decode.
``param_structs``, ``param_axes``
and ``cache_specs`` describe the weights and caches, with their logical
axes, without allocating them (the dry-run's input). The reference's
``scan_unroll`` served its dry-run's cost extrapolation over ``lax.scan``;
a Python loop over layers hides none from the FLOP counter, so it has no
counterpart.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import (DECODE_RULES, PREFILL_RULES,
                                              TRAIN_RULES, pspec_for)
from repro_torch.models import blocks
from repro_torch.models.blocks import LayerSpec, make_layer_spec
from repro_torch.models.common import ArraySpec, dtype_of, rms_norm
from repro_torch.models.moe import moe_batch_axes
from repro_torch.models.params import param_axes, param_specs
from repro_torch.tree import flatten


@dataclasses.dataclass(frozen=True)
class Segment:
    pattern: Tuple[LayerSpec, ...]
    repeat: int


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


def build_program(cfg: ModelConfig, *, decoder: bool = True,
                  num_layers: Optional[int] = None) -> List[Segment]:
    """A stack's layers as segments: the shortest period after which the
    decoder's layer pattern repeats (attention/SSM interleave, MoE period,
    local/global period), repeated, plus a tail; the encoder's layers are
    all alike."""
    n = num_layers if num_layers is not None else (
        cfg.num_layers if decoder else cfg.num_encoder_layers)
    period = 1
    if decoder:
        if cfg.ssm is not None and cfg.attn.attn_period > 1:
            period = _lcm(period, cfg.attn.attn_period)
        if cfg.moe is not None:
            period = _lcm(period, cfg.moe.period)
        if cfg.attn.global_period:
            period = _lcm(period, cfg.attn.global_period)
    period = min(period, n)
    specs = [make_layer_spec(cfg, i, decoder=decoder) for i in range(n)]
    segments = []
    full = n // period
    if full:
        segments.append(Segment(tuple(specs[:period]), full))
    rem = n % period
    if rem:
        # by periodicity, layers [full*period:] match spec positions [0:rem]
        segments.append(Segment(tuple(specs[full * period:]), 1))
    return segments


def _layer_specs(program: List[Segment]) -> List[LayerSpec]:
    return [sp for seg in program for _ in range(seg.repeat)
            for sp in seg.pattern]


class LM:
    """Functional LM over the weight tree ``{"layers": [per-layer dict,
    ...], "head": {...}[, "encoder": [per-layer dict, ...]]}``
    (``models/params.py``).

    ``prefill`` returns one cache dict per decoder layer: ``k``/``v`` (a
    ring of ``sliding_window`` slots on local layers), the SSM layers'
    ``conv_x``/``conv_b``/``conv_c``/``h``, and ``ck``/``cv`` (the encoder
    memory's keys and values) on cross-attention layers; ``decode_step``
    updates those caches in place.

    ``remat_group=g``: ``train_loss(..., remat=True)`` checkpoints every
    g consecutive decoder layers as one group, so it saves one activation
    per group and recomputes the group's layers in the backward.
    """

    def __init__(self, cfg: ModelConfig, *, remat_group: int = 1):
        if remat_group < 1:
            raise ValueError(f"remat_group must be >= 1, got {remat_group}")
        self.cfg = cfg
        self.remat_group = remat_group
        self.program = build_program(cfg, decoder=True)
        self.enc_program = (build_program(cfg, decoder=False)
                            if cfg.num_encoder_layers else [])
        self.specs = _layer_specs(self.program)
        self.enc_specs = _layer_specs(self.enc_program)

    # -- specs -----------------------------------------------------------

    def param_structs(self):
        """The weight tree with ``TensorSpec`` leaves (nothing allocated)."""
        return param_specs(self.cfg)

    def param_axes(self):
        """The weight tree with ``(logical axes, shape)`` leaves."""
        return param_axes(self.cfg)

    def cache_specs(self, batch: int, capacity: int, src_len: int = 0
                    ) -> List[Dict[str, ArraySpec]]:
        """One ``ArraySpec`` dict per decoder layer: the caches ``prefill``
        returns for ``capacity`` tokens (``src_len`` encoder frames for
        cross-attention), with their logical axes."""
        return [blocks.layer_cache_specs(self.cfg, spec, batch, capacity,
                                         src_len, self.cfg.dtype)
                for spec in self.specs]

    def _logits(self, params, h: torch.Tensor) -> torch.Tensor:
        head = params["head"]
        h = rms_norm(h, head["final_norm"], self.cfg.rms_eps)
        if self.cfg.tie_embeddings:
            return h @ head["embed"].T
        return h @ head["lm_head"]

    def _encode(self, params, src_embeds: torch.Tensor) -> torch.Tensor:
        """The encoder's memory (B, F, d): the projection in fp32, the
        non-causal stack, then ``enc_norm``."""
        cfg = self.cfg
        proj = src_embeds.float() @ params["head"]["frontend_proj"].float()
        x = proj.to(dtype_of(cfg.dtype))
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device).expand(B, S)
        for spec, p in zip(self.enc_specs, params["encoder"], strict=True):
            x, _ = blocks.apply_layer_seq(cfg, spec, p, x, positions)
        return rms_norm(x, params["head"]["enc_norm"], cfg.rms_eps)

    def _assemble_input(self, params, batch) -> torch.Tensor:
        """Token embeddings (B, S, d), after the projected frontend
        embeddings of a decoder-only config with a frontend."""
        head = params["head"]
        x = head["embed"][batch["tokens"]]
        if self.cfg.frontend.kind != "none" and not self.enc_program:
            emb = batch["embeds"].to(x.dtype)                # (B, F, e)
            x = torch.cat([(emb @ head["frontend_proj"]).to(x.dtype), x],
                          dim=1)
        return x

    @torch.no_grad()
    def prefill(self, params, batch: Dict[str, torch.Tensor], capacity: int,
                mesh=None):
        """batch: tokens (B, S) [+ embeds (B, F, e) or src_embeds (B, F,
        e)]. Positions (and so the decode's ``cache_len``) count a
        frontend's F embeddings first. Returns (last_logits (B, V),
        caches). With ``mesh`` (``params`` placed by ``spmd``), the logits
        whole on every position as a list, and caches of ``spmd.Placed``
        leaves under ``PREFILL_RULES``."""
        if mesh is not None:
            return self._prefill_mesh(params, batch, capacity, mesh)
        cfg = self.cfg
        memory = (self._encode(params, batch["src_embeds"])
                  if self.enc_program else None)
        x = self._assemble_input(params, batch)
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device).expand(B, S)
        caches = []
        for spec, p in zip(self.specs, params["layers"], strict=True):
            x, c = blocks.apply_layer_seq(cfg, spec, p, x, positions,
                                          memory=memory, want_cache=True,
                                          capacity=capacity)
            caches.append(c)
        return self._logits(params, x[:, -1]), caches

    @torch.no_grad()
    def decode_step(self, params, caches, batch, mesh=None):
        """batch: token (B,), cache_len int. Returns (logits (B, V), caches);
        the caches are updated in place; ``cache_len`` counts a frontend's
        F embeddings. With ``mesh`` (``params`` placed by ``spmd``, the
        caches ``spmd.Placed``, best under ``DECODE_RULES``:
        ``caches_for_decode``), the logits whole on every position as a
        list."""
        if mesh is not None:
            return self._decode_mesh(params, caches, batch, mesh)
        x = params["head"]["embed"][batch["token"]]          # (B, d)
        new_caches = []
        for spec, p, c in zip(self.specs, params["layers"], caches,
                               strict=True):
            x, nc = blocks.apply_layer_decode(self.cfg, spec, p, x, c,
                                              batch["cache_len"])
            new_caches.append(nc)
        return self._logits(params, x), new_caches

    def _run_layers(self, layers, x, positions, memory):
        for spec, p in layers:
            x, _ = blocks.apply_layer_seq(self.cfg, spec, p, x, positions,
                                          memory=memory)
        return x

    def train_loss(self, params, batch, *, remat: bool = True, mesh=None
                   ) -> torch.Tensor:
        """batch: tokens, labels, mask (B, S) [+ embeds or src_embeds]. The
        mean next-token NLL over the mask, from fp32 logits over the token
        region (after a frontend's embeddings). With ``mesh`` the weights
        are ``spmd.Placed`` leaves over it (``training.step.
        init_train_state(..., mesh=)``)."""
        if mesh is not None:
            return self._train_loss_mesh(params, batch, remat, mesh)
        cfg = self.cfg
        memory = (self._encode(params, batch["src_embeds"])
                  if self.enc_program else None)
        x = self._assemble_input(params, batch)
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device).expand(B, S)
        layers = list(zip(self.specs, params["layers"], strict=True))
        if remat:
            g = self.remat_group
            for i in range(0, len(layers), g):
                x = checkpoint(self._run_layers, layers[i:i + g], x,
                               positions, memory, use_reentrant=False)
        else:
            x = self._run_layers(layers, x, positions, memory)
        if cfg.frontend.kind != "none" and not self.enc_program:
            x = x[:, -batch["tokens"].shape[1]:]
        logits = self._logits(params, x).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            batch["labels"].long()[..., None])[..., 0]
        mask = batch["mask"].float()
        return ((logz - gold) * mask).sum() / torch.clamp(mask.sum(), min=1.0)

    # -- on a mesh --------------------------------------------------------

    def _remat_shards(self, layers, xs, positions, mesh, memory=None,
                      moe_axes=()):
        """``_run_shards`` over one remat group through ``_Remat``: the
        group's streams, the encoder's memory and the weight pieces are
        its inputs."""
        specs = [spec for spec, _ in layers]
        leaves, rebuild = flatten([p for _, p in layers])
        mem = list(memory or ())

        def run(xs, rest):
            out, i = [], len(mem)
            for x in leaves:
                out.append(x.like(rest[i:i + len(x.pieces)]))
                i += len(x.pieces)
            return self._run_shards(list(zip(specs, rebuild(out))), xs,
                                    positions, mesh, rest[:len(mem)] or None,
                                    moe_axes)

        pieces = [p for x in leaves for p in x.pieces]
        return list(_Remat.apply(run, len(xs), *xs, *mem, *pieces))

    def _run_shards(self, layers, xs, positions, mesh, memory=None,
                    moe_axes=()):
        for spec, p in layers:
            ws = blocks.shard_weights(self.cfg, p, mesh)
            xs = blocks.apply_layer_shards(self.cfg, spec, mesh, ws, xs,
                                           positions, memory, moe_axes)
            del ws
        return xs

    def _encode_shards(self, head, encoder, src, mesh):
        """``_encode`` over the mesh: each position projects its data
        shard's source frames ``src[r]`` in fp32 with ``frontend_proj``
        gathered over "data", runs the non-causal stack without remat and
        normalises; returns each position's copy of the memory."""
        cfg = self.cfg
        proj = spmd.gathered_over(head["frontend_proj"], "data")
        norm = spmd.gathered_over(head["enc_norm"], "data")
        xs = [(s.float() @ w.float()).to(dtype_of(cfg.dtype))
              for s, w in zip(src, proj)]
        positions = [torch.arange(x.shape[1], device=x.device).expand(
            x.shape[:2]) for x in xs]
        xs = self._run_shards(list(zip(self.enc_specs, encoder,
                                       strict=True)), xs, positions, mesh)
        return [rms_norm(x, n, cfg.rms_eps) for x, n in zip(xs, norm)]

    def _train_loss_mesh(self, params, batch, remat, mesh) -> torch.Tensor:
        """``train_loss`` over ``mesh``: the global masked mean, the sum of
        every batch piece's masked NLL over the whole batch's mask count.
        The batch splits over "pod" and "data" as ``TRAIN_RULES`` lay it
        (``batch_split``; whole on every position where they do not
        divide it, each piece then counted once, and the experts split
        the rows as ``moe.moe_batch_axes`` says). An encoder's memory
        comes first (``_encode_shards``). The
        embedding is a masked lookup in each model shard's vocabulary
        rows, all-reduced, with a frontend's projected embeddings ahead
        of it; the loss takes the logsumexp and the gold logit across the
        vocabulary shards (the max first, then the sums) over the token
        region."""
        cfg = self.cfg
        check_mesh_support(mesh)
        B, S = batch["tokens"].shape
        axes = batch_split(mesh, TRAIN_RULES, B)
        moe_axes = () if axes else moe_batch_axes(mesh, B)
        b, V = B // _positions(mesh, axes), cfg.vocab_size
        devs = mesh.devices

        def rows(k, r):
            return _data_rows(batch[k], mesh, r, b, axes)

        def vocab_cols(r, n):
            """(first vocabulary row of position r's shard, its rows)."""
            return (mesh.axis_index(r, "model") * n if n != V else 0), n

        head = params["head"]
        memory = (self._encode_shards(
            head, params["encoder"],
            [rows("src_embeds", r) for r in range(mesh.size)], mesh)
            if self.enc_program else None)
        emb = spmd.gathered_over(head["embed"], "data")
        xs = self._vocab_lookup(emb, [rows("tokens", r)
                                      for r in range(mesh.size)], mesh)
        frontend = cfg.frontend.kind != "none" and not self.enc_program
        if frontend:
            xs = self._frontend_shards(head, xs, [rows("embeds", r)
                                                  for r in range(mesh.size)])
        n_in = xs[0].shape[1]
        positions = [torch.arange(n_in, device=d).expand(b, n_in)
                     for d in devs]
        layers = list(zip(self.specs, params["layers"], strict=True))
        g = self.remat_group if remat else len(layers)
        for i in range(0, len(layers), g):
            group = layers[i:i + g]
            xs = (self._remat_shards(group, xs, positions, mesh, memory,
                                     moe_axes)
                  if remat else
                  self._run_shards(group, xs, positions, mesh, memory,
                                   moe_axes))
        if frontend:
            xs = [x[:, -S:] for x in xs]

        norm = spmd.gathered_over(head["final_norm"], "data")
        out = (emb if cfg.tie_embeddings
               else spmd.gathered_over(head["lm_head"], "data"))
        split = (out[0].shape[0] if cfg.tie_embeddings
                 else out[0].shape[1]) != V
        # with the vocabulary whole, one position of each data row computes
        # the logits; the other copies of its stream get no gradient
        live = [r for r in range(mesh.size)
                if split or mesh.axis_index(r, "model") == 0]
        logits, top, gold = {}, {}, {}
        for r in live:
            h = rms_norm(xs[r], norm[r], cfg.rms_eps)
            z = (h @ out[r].T if cfg.tie_embeddings else h @ out[r]).float()
            off, n = vocab_cols(r, z.shape[-1])
            lab = rows("labels", r).long() - off
            inside = (lab >= 0) & (lab < n)
            logits[r] = z
            top[r] = z.amax(dim=-1)
            gold[r] = torch.gather(z, -1, lab.clamp(0, n - 1)[..., None]
                                   )[..., 0] * inside
        if split:
            top = dict(enumerate(spmd.all_reduce_max(
                [top[r] for r in range(mesh.size)], mesh, "model")))
        sums = {r: torch.exp(logits[r] - top[r][..., None]).sum(dim=-1)
                for r in live}
        if split:
            sums = dict(enumerate(spmd.all_reduce(
                [sums[r] for r in range(mesh.size)], mesh, "model")))
            gold = dict(enumerate(spmd.all_reduce(
                [gold[r] for r in range(mesh.size)], mesh, "model")))
        total = None
        once = _batch_once(mesh, axes)
        for members in spmd.groups(mesh, "model"):
            r = members[0]
            if r not in once:
                continue
            nll = top[r] + torch.log(sums[r]) - gold[r]
            part = (nll * rows("mask", r).float()).sum().to(devs[0])
            total = part if total is None else total + part
        count = batch["mask"].float().sum().to(devs[0])
        return total / torch.clamp(count, min=1.0)

    def _vocab_lookup(self, emb: List[torch.Tensor], toks, mesh):
        """Each position's embedding of its tokens ``toks[r]`` from its
        rows of the table ``emb[r]``: where the vocabulary splits over
        "model", a masked lookup in the shard's rows, all-reduced."""
        V = self.cfg.vocab_size
        xs = []
        for r, (e, tok) in enumerate(zip(emb, toks)):
            tok, n = tok.long(), e.shape[0]
            if n == V:
                xs.append(e[tok])
                continue
            idx = tok - mesh.axis_index(r, "model") * n
            inside = (idx >= 0) & (idx < n)
            xs.append(e[idx.clamp(0, n - 1)] * inside[..., None].to(e.dtype))
        if emb[0].shape[0] != V:
            xs = spmd.all_reduce(xs, mesh, "model")
        return xs

    def _frontend_shards(self, head, xs, embeds):
        """Each position's frontend embeddings ``embeds[r]`` (its data
        row's, (b, F, e)) projected with ``frontend_proj`` gathered over
        "data", ahead of its token embeddings ``xs[r]``."""
        proj = spmd.gathered_over(head["frontend_proj"], "data")
        return [torch.cat([(e.to(x.dtype) @ w).to(x.dtype), x], dim=1)
                for x, e, w in zip(xs, embeds, proj)]

    def _prefill_mesh(self, params, batch, capacity: int, mesh):
        """``prefill`` over ``mesh`` under ``PREFILL_RULES``: each data row
        (of each pod) takes its share of the batch, of its frontend
        embeddings or of its source frames (``batch_split``: all of them
        where the pods and data rows do not divide the batch, the experts
        then splitting the rows as ``moe.moe_batch_axes`` says); an
        encoder's memory first (``_encode_shards``), each
        position's copy feeding its cross-attention; a frontend's
        projected embeddings ahead of the tokens; the weights gathered
        over "data" layer by layer (``blocks.shard_weights``), each
        position's q heads through flash, its SSM channels and heads, its
        experts over its data row's tokens
        (``blocks.apply_layer_shards_prefill``); the logits from each
        position's vocabulary shard, gathered over "model", then over
        "pod" and "data"."""
        cfg = self.cfg
        check_mesh_support(mesh, "prefill")
        B, S = batch["tokens"].shape
        axes = batch_split(mesh, PREFILL_RULES, B)
        moe_axes = () if axes else moe_batch_axes(mesh, B)
        b = B // _positions(mesh, axes)
        devs = mesh.devices

        def rows(k):
            return [_data_rows(batch[k], mesh, r, b, axes)
                    for r in range(mesh.size)]

        head = params["head"]
        memory, src_len = None, 0
        if self.enc_program:
            memory = self._encode_shards(head, params["encoder"],
                                         rows("src_embeds"), mesh)
            src_len = batch["src_embeds"].shape[1]
        emb = spmd.gathered_over(head["embed"], "data")
        xs = self._vocab_lookup(emb, rows("tokens"), mesh)
        if cfg.frontend.kind != "none" and not self.enc_program:
            xs = self._frontend_shards(head, xs, rows("embeds"))
        n_in = xs[0].shape[1]
        positions = [torch.arange(n_in, device=d).expand(b, n_in)
                     for d in devs]
        caches = []
        for spec, p, cs in zip(self.specs, params["layers"],
                               self.cache_specs(B, capacity, src_len),
                               strict=True):
            ws = blocks.shard_weights(cfg, p, mesh, pick_kv=False)
            xs, c = blocks.apply_layer_shards_prefill(
                cfg, spec, mesh, ws, xs, positions, cs, PREFILL_RULES,
                memory, moe_axes)
            caches.append(c)
            del ws
        norm = spmd.gathered_over(head["final_norm"], "data")
        out = (emb if cfg.tie_embeddings
               else spmd.gathered_over(head["lm_head"], "data"))
        zs = []
        for x, n, w in zip(xs, norm, out):
            h = rms_norm(x[:, -1], n, cfg.rms_eps)
            zs.append(h @ w.T if cfg.tie_embeddings else h @ w)
        if zs[0].shape[-1] != cfg.vocab_size:
            zs = spmd.all_gather(zs, mesh, "model", dim=-1)
        if axes:
            zs = spmd.all_gather(zs, mesh, axes, dim=0)
        return zs, caches

    def _decode_mesh(self, params, caches, batch, mesh):
        """``decode_step`` over ``mesh`` under ``DECODE_RULES``: the token
        embedded from each position's (vocabulary, d) piece of the table
        and summed over "model" (a frontend's embeddings are in the caches
        already, and ``cache_len`` counts them), the layers
        weight-stationary (``blocks.apply_layer_shards_decode``: an
        encoder-decoder's cross-attention reads its cross caches), the
        logits each position's vocabulary shard from its d piece, summed
        over "data" and gathered over "model"."""
        cfg = self.cfg
        check_mesh_support(mesh, "decode")
        head = params["head"]
        tok = batch["token"]
        cache_len = int(batch["cache_len"])
        xs = self._vocab_lookup(head["embed"].pieces,
                                [tok.to(d) for d in mesh.devices], mesh)
        for spec, p, c in zip(self.specs, params["layers"], caches,
                              strict=True):
            xs = blocks.apply_layer_shards_decode(cfg, spec, mesh, p, xs, c,
                                                  cache_len)
        hs = blocks.norm_pieces(cfg, mesh, xs, head["final_norm"].pieces)
        zs = [h @ w.T if cfg.tie_embeddings else h @ w for h, w in zip(
            hs, (head["embed"] if cfg.tie_embeddings
                 else head["lm_head"]).pieces)]
        if xs[0].shape[-1] != cfg.d_model:
            zs = spmd.all_reduce(zs, mesh, "data")
        if zs[0].shape[-1] != cfg.vocab_size:
            zs = spmd.all_gather(zs, mesh, "model", dim=-1)
        return zs, caches

    @staticmethod
    def caches_for_decode(caches):
        """A prefill's ``spmd.Placed`` caches laid out under
        ``DECODE_RULES`` (``spmd.relayout_tree``): the reference's
        ``device_put`` to the decode cell's ``in_shardings``, its bytes
        counted by ``spmd.moved_bytes``."""
        return spmd.relayout_tree(caches, DECODE_RULES)


class _Remat(torch.autograd.Function):
    """Rematerialization of a function of tensors, for the mesh path: the
    forward runs ``run(xs, pieces)`` without a graph and keeps only its
    inputs; the backward runs it again with one and takes the inputs'
    gradients with ``torch.autograd.grad``, a nested backward that waits
    on the calling thread. Inputs: ``run``, the count of ``xs``, then the
    ``xs`` and the weight pieces."""

    @staticmethod
    def forward(ctx, run, n_x, *tensors):
        ctx.run, ctx.n_x = run, n_x
        ctx.save_for_backward(*tensors)
        out = run(list(tensors[:n_x]), list(tensors[n_x:]))
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        ins = [t.detach().requires_grad_(t.requires_grad)
               for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = ctx.run(ins[:ctx.n_x], ins[ctx.n_x:])
        live = [i for i, t in enumerate(ins) if t.requires_grad]
        got = torch.autograd.grad(out, [ins[i] for i in live], grads,
                                  allow_unused=True)
        full = [None] * len(ins)
        for i, g in zip(live, got):
            full[i] = g
        return (None, None, *full)


def batch_split(mesh, rules, batch: int) -> Tuple[str, ...]:
    """The mesh axes a batch of ``batch`` rows splits over under ``rules``
    (``pspec_for``: "pod" and "data", those the mesh has, where their
    positions together divide it; none where they do not)."""
    spec = pspec_for(("batch",), mesh, rules, (batch,))
    if not spec:
        return ()
    return (spec[0],) if isinstance(spec[0], str) else tuple(spec[0])


def _positions(mesh, axes: Tuple[str, ...]) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def _batch_once(mesh, axes: Tuple[str, ...]) -> set:
    """The positions that count their batch piece once: those at index 0
    along each batch axis ("pod", "data") that does not split it."""
    copies = [a for a in ("pod", "data") if a in mesh.shape and a not in axes]
    return {r for r in range(mesh.size)
            if all(mesh.axis_index(r, a) == 0 for a in copies)}


def _data_rows(t: torch.Tensor, mesh, r: int, b: int,
               axes: Tuple[str, ...]) -> torch.Tensor:
    """Position ``r``'s ``b`` rows of ``t`` (B, ...) on its device, its
    piece along the batch axes ``axes`` (``batch_split``): all of them
    where ``b`` is B."""
    if b != t.shape[0]:
        t = t.narrow(0, spmd.piece_index((axes,), mesh, r)[0] * b, b)
    return t.to(mesh.devices[r])


def check_mesh_support(mesh, kind: str = "train") -> None:
    """The meshes the mesh path runs: a mesh of devices over "data" and
    "model", with "pod" ahead of them on a multi-pod mesh, to train,
    prefill or decode (``kind``) every family (dense, MoE, SSM, hybrid,
    encoder-decoder, frontend). Any other mesh axis raises: no sharding
    rule names one."""
    if kind not in ("train", "prefill", "decode"):
        raise ValueError(f"check_mesh_support: kind {kind!r} is not train, "
                         f"prefill or decode")
    if mesh.devices is None:
        raise ValueError(f"{kind} on a mesh needs its devices "
                         f"(launch.mesh.make_mesh)")
    extra = set(mesh.axis_names) - {"pod", "data", "model"}
    if extra:
        raise NotImplementedError(
            f"mesh axes {sorted(extra)}: the mesh path runs over 'pod', "
            f"'data' and 'model' only, the axes the sharding rules name")
