"""PagedModelRunner: batched real execution over a pooled block-first KV
cache, on the hand-written CUDA kernels and DuplexKV (paper §4.3).

The port of ``src/repro/serving/paged_runner.py``, in bf16/fp32 and in
the int8 KV tier, on one device or tensor-parallel. The engine's logical block decisions
ARE the physical layout: one pooled ``(rows, L, 2, P, Hkv, D)`` device
tensor holds every layer of one logical KV block contiguously per row, and
rows are addressed by the ``TwoTierBlockTable``'s ``hbm_slot``s — the same
integers the scheduler budgets with.

* **Decode** is ONE batched paged-attention launch per layer per iteration
  (``kernels/paged_attention.py``; the kernel reads the block table), with
  the layered pool and ``layer=li``: no per-layer slice is copied.
* **Chunked prefill** scatters each chunk's K/V into the request's rows,
  gathers the block context, and runs the flash kernel with
  ``q_offset = start`` (``kernels/flash_attention.py``), so prefill resumes
  mid-prompt after a rotation with no recompute.
* **Rotation, CoW forks and prefix-cache promotion are physical row
  movement**: ``PagedKVStore`` executes every ``TransferDesc`` the DuplexKV
  times as a batched ``kv_copy`` launch through a staging region, plus one
  contiguous host copy per chunk to or from the host tier.
* **The int8 KV tier** (``ServingConfig.kv_dtype == "int8"``): the pool
  holds int8 values, and a parallel fp32 scale tensor, one scale per (row,
  layer, K/V side, kv head), rides every row movement with the same slot
  indices. K/V writes go through ``kernels/quant.py::quant_store_tokens``
  (running block scales); decode runs the paged kernel's int8 mode, which
  dequantizes inside the kernel; prefill dequantizes the gathered context
  before the flash kernel.

* **Tensor parallelism** (``ServingConfig.tp > 1``): one logical replica
  over a 1-D ``("model",)`` mesh of ``tp`` shards (``distributed/tp.py``,
  ``launch.mesh.make_tp_mesh``). Each shard holds its own contiguous
  slice of the weights (q/k/v heads and ``wo`` rows by kv-head group,
  ``d_ff`` of the MLP) and a pool of ``Hkv/tp`` heads per row; the row
  dim keeps its GLOBAL slot ids, so the block table, DuplexKV and the
  prefix cache never see TP. Each shard runs the same kernels on its own
  heads; the partial sums of ``wo`` and ``w_down`` are all-reduced before
  the residual add. When ``tp > num_kv_heads`` attention and the pool are
  replicated and only the MLP shards. The host tier holds full global
  rows. At ``tp == 1`` there is one shard and no reduction.

Where JAX donated the pool to each jitted call, the port updates the pool
and the scales in place (the K/V token stores and every row copy), so
their storage never moves. The reference keeps separate ``_*_impl_q``
functions so its bf16 jaxpr stays byte-identical; eager PyTorch has no
such trace, so the int8 tier is a branch in ``_store_kv`` and
``_context`` and the kernel call's ``kv_scales``. Iteration wall-time
still comes from a ``SimExecutor``.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.configs.base import (GH200, HardwareProfile, ModelConfig,
                                      ServingConfig)
from repro_torch.core.blocktable import BlockLoc
from repro_torch.core.types import RequestState
from repro_torch.device import resolve_device
from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import Mesh
from repro_torch.distributed.tp import (TPPlan, head_pspecs, layer_pspecs,
                                        plan_tp_sharding)
from repro_torch.kernels.kv_copy import kv_copy
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.quant import kv_scale_shape, quant_store_tokens
from repro_torch.models.attention import flash_attention
from repro_torch.models.common import apply_rope, dtype_of, rms_norm, swiglu
from repro_torch.models.params import init_params
from repro_torch.serving.executor import (ExecutionResult, Executor,
                                          PendingExecution, SimExecutor)


def _pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1): bounds the distinct batch and
    context shapes the kernels see to O(log)."""
    return 1 << max(n - 1, 0).bit_length()


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class PagedKVStore:
    """Physical two-tier KV storage behind the block table's slot numbers.

    Device tier: one pool tensor of ``num_hbm_blocks`` rows plus a staging
    region (``staging`` rows) and one trash row (scatter target for padded
    batch lanes); with ``kv_dtype="int8"`` an int8 pool plus a fp32
    ``scales`` tensor of the same rows. Host tier: a dict keyed by DRAM slot
    whose values are CPU tensors, one row each (a ``(int8 row, fp32 scale
    row)`` tuple in the int8 tier), which DuplexKV may move by reference;
    row movement never requantizes. Implements the DuplexKV data-backend
    protocol (``run_d2d``/``run_d2h``/``run_h2d``): each direction is a
    batched ``kv_copy`` launch through staging plus one contiguous host
    copy.

    With a ``tp_plan`` and its ``mesh`` the device tier is one pool (and
    scale tensor) per shard, ``pools[i]`` on ``mesh.devices[i]``, of
    ``Hkv/kv_shards`` heads; ``pool``/``scales`` are shard 0's. Every row
    movement runs on every shard with the same slots. The host tier holds
    full global rows: a readback concatenates the shards' heads, an upload
    splits them; a replicated plan (``kv_shards == 1``) writes every shard
    and reads shard 0.
    """

    def __init__(self, cfg: ModelConfig, serving: ServingConfig,
                 dtype: torch.dtype, *, device=None, staging: int = 64,
                 double_buffer: bool = False, kv_dtype: str = "bf16",
                 tp_plan: Optional[TPPlan] = None,
                 mesh: Optional[Mesh] = None):
        if kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_dtype must be 'bf16' or 'int8', "
                             f"got {kv_dtype!r}")
        if staging < 1 or staging & (staging - 1):
            # chunk padding rounds up to a power of two; a non-pow2 staging
            # region would let a padded chunk spill past it into live rows
            raise ValueError(f"staging must be a power of two, got {staging}")
        if double_buffer and staging < 4:
            raise ValueError(
                f"double_buffer splits staging into an H2D half and two D2H "
                f"gather buffers; needs staging >= 4, got {staging}")
        if (mesh is None) != (tp_plan is None):
            raise ValueError("a tensor-parallel store needs both tp_plan "
                             "and mesh")
        L = cfg.num_layers
        P = serving.block_size
        self.devices = (list(mesh.devices) if mesh is not None
                        else [resolve_device(device)])
        self.device = self.devices[0]
        self.kv_shards = tp_plan.kv_shards if tp_plan is not None else 1
        self.nb = serving.num_hbm_blocks
        self.staging = staging
        self.double_buffer = double_buffer
        self.trash_row = self.nb + staging
        # Staging layout. Single-buffer (sync engine): both directions use
        # the whole region, one chunk at a time, host readback immediately
        # after each gather. Double-buffer (pipelined engine): H2D owns the
        # TOP half so an upload/scatter for iteration N+1 never aliases a
        # D2H gather still draining from iteration N; the BOTTOM half splits
        # into two alternating gather buffers so chunk i's gather launch is
        # issued before chunk i-1's host readback forces a sync (a software
        # pipeline over the copy stream).
        if double_buffer:
            self.h2d_base = self.nb + staging // 2
            self.h2d_chunk = staging // 2
            self.d2h_chunk = staging // 4
        else:
            self.h2d_base = self.nb
            self.h2d_chunk = staging
            self.d2h_chunk = staging
        # the global row (the host tier's) and one shard's
        self.row_shape = (L, 2, P, cfg.num_kv_heads, cfg.head_dim)
        self.shard_heads = cfg.num_kv_heads // self.kv_shards
        shard_row = (L, 2, P, self.shard_heads, cfg.head_dim)
        rows = self.nb + staging + 1
        # int8 tier: one fp32 scale per (row, layer, K/V side, kv head),
        # updated in place like the pool and moved with the same slots
        self.quantized = kv_dtype == "int8"
        self.scale_row_shape = None
        self.scale_shards: List[Optional[torch.Tensor]] = [None] * len(
            self.devices)
        if self.quantized:
            dtype = torch.int8
            self.scale_row_shape = kv_scale_shape(self.row_shape)
            self.scale_shards = [
                torch.zeros((rows,) + kv_scale_shape(shard_row),
                            dtype=torch.float32, device=d)
                for d in self.devices]
        self.pools: List[torch.Tensor] = [
            torch.zeros((rows,) + shard_row, dtype=dtype, device=d)
            for d in self.devices]
        # dram_slot -> CPU row | (int8 row, fp32 scale row)
        self.host: Dict[int, Union[torch.Tensor,
                                   Tuple[torch.Tensor, torch.Tensor]]] = {}
        # counters (benchmarks / tests); a launch here is one per row
        # movement, on every shard
        self.copy_launches = 0
        self.d2d_rows = 0
        self.d2h_rows = 0
        self.h2d_rows = 0
        # wall-clock seconds spent in row movement on the host (launches,
        # uploads, readbacks). Observability only — never fed back into the
        # sim clock, which stays the model's timing authority. Of them,
        # ``readback_wall_s`` (in ``copy_launch_wall_s``) copies rows back
        # to the host tier, ``kv_stack_wall_s`` (in
        # ``upload_launch_wall_s``) stacks host rows before an upload.
        self.copy_launch_wall_s = 0.0
        self.upload_launch_wall_s = 0.0
        self.readback_wall_s = 0.0
        self.kv_stack_wall_s = 0.0

    @property
    def pool(self) -> torch.Tensor:
        """The pool (shard 0's under tensor parallelism)."""
        return self.pools[0]

    @pool.setter
    def pool(self, t: torch.Tensor) -> None:
        self.pools[0] = t

    @property
    def scales(self) -> Optional[torch.Tensor]:
        """The int8 tier's scales (shard 0's under tensor parallelism)."""
        return self.scale_shards[0]

    @scales.setter
    def scales(self, t: Optional[torch.Tensor]) -> None:
        self.scale_shards[0] = t

    @property
    def pool_shard_bytes(self) -> int:
        """Bytes ONE device holds: global/kv_shards when the kv-head dim is
        sharded, the full pool when replicated or at ``tp == 1``; scales
        included in the int8 tier (they are part of the KV footprint)."""
        n = self.pool.numel() * self.pool.element_size()
        if self.quantized:
            n += self.scales.numel() * self.scales.element_size()
        return n

    @property
    def pool_global_bytes(self) -> int:
        return self.pool_shard_bytes * self.kv_shards

    def _split(self, x: torch.Tensor, i: int, dim: int) -> torch.Tensor:
        """Shard ``i``'s kv heads of global rows ``x`` (dim ``dim``)."""
        if self.kv_shards == 1:
            return x
        return x.narrow(dim, i * self.shard_heads, self.shard_heads)

    def _join(self, parts: List[torch.Tensor], dim: int) -> torch.Tensor:
        """Global rows from the shards' rows (shard 0's if replicated),
        joined on shard 0's device."""
        if self.kv_shards == 1:
            return parts[0]
        return torch.cat([p.to(self.device) for p in parts], dim)

    def _upload(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Host rows ``x`` for each shard: one upload a device, split there
        (at ``tp == 1``, ``x`` itself, copied straight into the pool)."""
        if len(self.pools) == 1:
            return [x]
        on: Dict[torch.device, torch.Tensor] = {}
        for p in self.pools:
            if p.device not in on:
                on[p.device] = x.to(p.device)
        return [on[p.device] for p in self.pools]

    def _copy_rows(self, src: Sequence[int], dst: Sequence[int]) -> None:
        """One batched row-copy launch: pool[dst[i]] = pool[src[i]] (and a
        second launch with the same descriptors on the scale rows in the
        int8 tier). Padded to a power of two with no-op descriptors
        (src < 0)."""
        n = len(src)
        np2 = _pow2(n)
        s = np.full(np2, -1, np.int32)
        d = np.zeros(np2, np.int32)
        s[:n], d[:n] = src, dst
        t0 = time.perf_counter()
        with record_function("superinfer.kv_copy"):
            for pool, scales in zip(self.pools, self.scale_shards):
                kv_copy(pool.view(pool.shape[0], -1), s, d)
                if self.quantized:
                    kv_copy(scales.view(scales.shape[0], -1), s, d)
        self.copy_launch_wall_s += time.perf_counter() - t0
        self.copy_launches += 1

    # -- DuplexKV data-backend protocol ------------------------------------
    def run_d2d(self, pairs: Sequence[Tuple[int, int]]) -> None:
        """Intra-pool row copies (copy-on-write forks)."""
        if not pairs:
            return
        self._copy_rows([p[0] for p in pairs], [p[1] for p in pairs])
        self.d2d_rows += len(pairs)

    def _readback(self, base: int, chunk) -> None:
        """Copy gathered staging rows into the host tier. Syncs with the
        device — in double-buffer mode this is deferred one chunk so the
        next gather launch is already queued."""
        n = len(chunk)
        k = self.kv_shards
        with record_function("superinfer.kv_readback"):
            t0 = time.perf_counter()
            data = self._join([p[base:base + n] for p in self.pools[:k]],
                              -2).cpu()
            if self.quantized:
                sdata = self._join([sc[base:base + n]
                                    for sc in self.scale_shards[:k]],
                                   -1).cpu()
                for j, d in enumerate(chunk):
                    self.host[d.dst_slot] = (data[j].clone(),
                                             sdata[j].clone())
            else:
                for j, d in enumerate(chunk):
                    self.host[d.dst_slot] = data[j].clone()
            dt = time.perf_counter() - t0
        self.copy_launch_wall_s += dt
        self.readback_wall_s += dt
        self.d2h_rows += n

    def run_d2h(self, descs) -> None:
        """Device rows -> host tier: batched gather into staging (one
        ``kv_copy`` launch), then ONE contiguous device->host copy.
        Double-buffer mode alternates two gather buffers, reading chunk
        i-1 back only after chunk i's gather is dispatched."""
        q = self.d2h_chunk
        pending = None                      # (base, chunk) awaiting readback
        for i in range(0, len(descs), q):
            chunk = descs[i:i + q]
            base = self.nb + (q if self.double_buffer and (i // q) % 2
                              else 0)
            self._copy_rows([d.src_slot for d in chunk],
                            list(range(base, base + len(chunk))))
            if not self.double_buffer:
                self._readback(base, chunk)
                continue
            if pending is not None:
                self._readback(*pending)
            pending = (base, chunk)
        if pending is not None:
            self._readback(*pending)

    def run_h2d(self, descs) -> None:
        """Host tier -> device rows: one contiguous host->device upload into
        staging (the H2D half, in double-buffer mode), then a batched
        ``kv_copy`` scatter into place."""
        for i in range(0, len(descs), self.h2d_chunk):
            chunk = descs[i:i + self.h2d_chunk]
            n = len(chunk)
            rows = []
            for d in chunk:
                row = self.host.get(d.src_slot)
                if row is None:
                    raise RuntimeError(
                        f"h2d for block {d.block_id}: DRAM slot "
                        f"{d.src_slot} holds no data (lost copy)")
                rows.append(row)
            t0 = time.perf_counter()
            base = self.h2d_base
            with record_function("superinfer.kv_upload"):
                with record_function("superinfer.kv_stack"):
                    s0 = time.perf_counter()
                    if self.quantized:
                        stacked = (torch.stack([r[0] for r in rows]),
                                   torch.stack([r[1] for r in rows]))
                    else:
                        stacked = (torch.stack(rows),)
                    self.kv_stack_wall_s += time.perf_counter() - s0
                vals = self._upload(stacked[0])
                if self.quantized:
                    svals = self._upload(stacked[1])
                for i, (pool, scales) in enumerate(zip(self.pools,
                                                       self.scale_shards)):
                    pool[base:base + n].copy_(self._split(vals[i], i, -2))
                    if self.quantized:
                        scales[base:base + n].copy_(
                            self._split(svals[i], i, -1))
            self.upload_launch_wall_s += time.perf_counter() - t0
            self._copy_rows(list(range(self.h2d_base, self.h2d_base + n)),
                            [d.dst_slot for d in chunk])
            self.h2d_rows += n


class PagedModelRunner(Executor):
    """Batched real execution against the pooled block-first KV cache.

    ``model_cfg`` is the config actually executed; iteration wall-time
    still comes from a ``SimExecutor`` — pass ``timing_cfg`` to keep timing
    calibrated to the full-size model while executing a reduced one.
    Weights come from ``params`` (``models.params.from_jax_params`` or
    ``init_params``), or are drawn from ``seed`` with a ``torch.Generator``
    on ``device``. ``device`` defaults to CUDA; with no CUDA device only an
    explicit ``device="cpu"`` runs. The runner binds to the engine's
    DuplexKV (``bind``), sizing the device pool to the block table and
    attaching its ``PagedKVStore`` as the table's physical data backend.

    ``record_margins = True`` makes the runner keep, per request, the top-2
    logit margin of every token it emits (``margins``), read in the same
    host sync as the tokens.

    With ``serving.tp > 1`` the runner spans the ``tp`` shards of
    ``make_tp_mesh(tp, device)`` (``device`` may then be a list of ``tp``
    devices): the full weights are sliced once, up front, by
    ``layer_pspecs`` onto each shard's device (every shard gets its own
    copy of the replicated head), and ``_layers``/``_head`` are shard 0's.
    ``attn_launches`` stays one per layer per decode iteration whatever
    ``tp`` is; the kernel modules' counters count each shard's launch.
    """

    supports_prefix_cache = True

    def __init__(self, model_cfg: ModelConfig, serving: ServingConfig,
                 hw: HardwareProfile = GH200, *, seed: int = 0,
                 sim: Optional[SimExecutor] = None,
                 timing_cfg: Optional[ModelConfig] = None,
                 params: Optional[dict] = None, device=None):
        unsupported = []
        if model_cfg.num_encoder_layers or model_cfg.frontend.kind != "none":
            unsupported.append("encoder/frontend stacks")
        for i in range(model_cfg.num_layers):
            if (model_cfg.layer_kind(i) != "attn" or model_cfg.family == "ssm"
                    or not model_cfg.layer_is_global(i)
                    or model_cfg.layer_is_moe(i)):
                unsupported.append(f"layer {i}")
                break
        if unsupported:
            raise ValueError(
                "PagedModelRunner supports uniform dense-attention decoder "
                f"configs only; {model_cfg.name} has " + ", ".join(unsupported))
        self.kv_dtype = getattr(serving, "kv_dtype", "bf16") or "bf16"
        self.cfg = model_cfg
        self.serving = serving
        self.tp = int(getattr(serving, "tp", 1) or 1)
        self.tp_plan = plan_tp_sharding(model_cfg, self.tp)
        self.mesh: Optional[Mesh] = None
        if self.tp_plan.trivial:
            self.devices = [resolve_device(device)]
        else:
            from repro_torch.launch.mesh import make_tp_mesh
            self.mesh = make_tp_mesh(self.tp, device)
            self.devices = list(self.mesh.devices)
        self.device = self.devices[0]
        self.sim = sim or SimExecutor(timing_cfg or model_cfg, hw,
                                      tp=self.tp, kv_dtype=self.kv_dtype)
        self.dtype = dtype_of(model_cfg.dtype)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(model_cfg, gen, self.device, self.dtype)
        layers, head = params["layers"], params["head"]
        if len(layers) != model_cfg.num_layers:
            raise ValueError(f"params hold {len(layers)} layers, "
                             f"{model_cfg.name} has {model_cfg.num_layers}")
        if self.mesh is None:
            self._shards: List[Tuple[List[dict], dict]] = [(layers, head)]
        else:
            lp, hp = layer_pspecs(self.tp_plan), head_pspecs(head)
            pl = [{k: spmd.place_spec(v, lp[k], self.mesh).pieces
                   for k, v in layer.items()} for layer in layers]
            ph = {k: spmd.place_spec(v, hp[k], self.mesh).pieces
                  for k, v in head.items()}
            self._shards = [
                ([{k: ps[i] for k, ps in layer.items()} for layer in pl],
                 {k: ps[i] for k, ps in ph.items()})
                for i in range(self.tp)]
        self._layers, self._head = self._shards[0]
        self.store: Optional[PagedKVStore] = None
        self.kv = None
        self.record_margins = False
        self.margins: Dict[int, List[float]] = {}
        # counters (benchmarks / tests): decode launch count is per-layer,
        # INDEPENDENT of batch size — the whole point of the batched path
        self.decode_batches = 0
        self.decode_tokens = 0
        self.attn_launches = 0
        self.prefill_chunks_run = 0
        # host-side dispatch wall time per launch family, and the host
        # blocked on the device in the iteration's one sync (observability
        # only; the sim clock never reads these)
        self.prefill_launch_wall_s = 0.0
        self.decode_launch_wall_s = 0.0
        self.sync_wall_s = 0.0

    # ------------------------------------------------------------- binding
    def bind(self, kv) -> None:
        """Attach to the engine's DuplexKV: allocate the device pool sized
        to its block table and register as the physical data backend."""
        self.kv = kv
        self.store = PagedKVStore(
            self.cfg, self.serving, self.dtype, device=self.device,
            double_buffer=bool(getattr(self.serving, "pipeline", False)),
            kv_dtype=self.kv_dtype,
            tp_plan=None if self.mesh is None else self.tp_plan,
            mesh=self.mesh)
        kv.attach_data_backend(self.store)

    # ------------------------------------------------------ executor protocol
    def step_time(self, plan) -> float:
        return self.sim.step_time(plan)

    def plan_time(self, plan) -> float:
        return self.sim.plan_time(plan)

    def execute(self, plan, requests) -> ExecutionResult:
        return self.execute_async(plan, requests).wait()

    def execute_async(self, plan, requests) -> PendingExecution:
        """Enqueue every launch of the iteration without a host sync: the
        prefill-chunk argmaxes and the batched decode output stay on the
        device, and ``wait()`` brings them back in ONE copy — the
        iteration's single sync point."""
        if self.store is None:
            raise RuntimeError("PagedModelRunner.bind(kv) was never called")
        outs: List[Tuple[List[int], torch.Tensor]] = []  # (req_ids, top-2)
        for rid, take in plan.prefill_chunks:
            r = requests.get(rid)
            if r is None or r.prompt_ids is None:
                continue
            top = self._run_prefill_chunk(r, take)
            if top is not None:
                outs.append(([rid], top[None]))
        dec = []
        for rid in plan.decode_reqs:
            r = requests.get(rid)
            if (r is None or r.state != RequestState.RUNNING
                    or not r.generated_ids):
                continue
            dec.append(r)
        if dec:
            outs.append(([r.req_id for r in dec], self._run_decode_batch(dec)))

        def waiter() -> ExecutionResult:
            out = ExecutionResult()
            if not outs:
                return out
            with record_function("superinfer.sync"):
                t0 = time.perf_counter()
                vals = torch.cat([t[:len(ids)] for ids, t in outs]).cpu()
                self.sync_wall_s += time.perf_counter() - t0
            rids = [rid for ids, _ in outs for rid in ids]
            for rid, (tok, margin) in zip(rids, vals.tolist()):
                out.tokens[rid] = int(tok)
                if self.record_margins:
                    self.margins.setdefault(rid, []).append(margin)
            return out

        return PendingExecution(waiter)

    # rotation data movement rides the DuplexKV transfer descriptors (the
    # PagedKVStore backend); there is no per-request device state to move
    def swap_out(self, req_id: int) -> None:
        pass

    def swap_in(self, req_id: int) -> None:
        pass

    def drop(self, req_id: int) -> None:
        pass

    # ---------------------------------------------------------- device work
    def _rows(self, req_id: int) -> List[int]:
        """HBM pool rows of the request's blocks, in position order — the
        physical block table handed to the kernels."""
        rows = []
        for b in self.kv.table.blocks_of(req_id):
            if b.hbm_slot is None or b.loc == BlockLoc.DRAM:
                raise RuntimeError(
                    f"block {b.block_id} of scheduled request {req_id} is "
                    f"not HBM-resident ({b.loc})")
            rows.append(b.hbm_slot)
        return rows

    def _ids(self, a: np.ndarray) -> torch.Tensor:
        """Upload host indices without waiting on the device (pinned
        memory, asynchronous copy)."""
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _run_prefill_chunk(self, r, take: int) -> Optional[torch.Tensor]:
        """Run one prefill chunk; return (argmax, top-2 margin) on the
        device when the chunk completes the prompt, else None."""
        P = self.serving.block_size
        start = r.prefill_pos
        take = min(take, r.prompt_len - start)
        if take <= 0:
            return None
        ids = r.prompt_ids[start:start + take]
        rows = self._rows(r.req_id)
        nb_ctx = _cdiv(start + take, P)
        if len(rows) < nb_ctx:
            raise RuntimeError(
                f"req {r.req_id}: {len(rows)} blocks assigned, prefill "
                f"needs {nb_ctx}")
        tp, mbp = _pow2(take), _pow2(nb_ctx)
        ids_p = np.zeros(tp, np.int32)
        ids_p[:take] = ids
        rows_p = np.full(mbp, self.store.trash_row, np.int32)
        rows_p[:min(len(rows), mbp)] = rows[:mbp]
        t0 = time.perf_counter()
        with record_function("superinfer.prefill_chunk"):
            top = self._prefill(self._ids(ids_p), start, take,
                                self._ids(rows_p))
        self.prefill_launch_wall_s += time.perf_counter() - t0
        self.prefill_chunks_run += 1
        if start + take >= r.prompt_len and r.tokens_generated == 0:
            return top
        return None

    def _run_decode_batch(self, dec) -> torch.Tensor:
        """One batched decode iteration; returns (B_pad, 2) rows of
        (argmax, top-2 margin) on the device."""
        P = self.serving.block_size
        cls = [r.total_len - 1 for r in dec]
        rows = [self._rows(r.req_id) for r in dec]
        for r, cl, rw in zip(dec, cls, rows):
            if len(rw) < _cdiv(cl + 1, P):
                raise RuntimeError(
                    f"req {r.req_id}: {len(rw)} blocks assigned, decode at "
                    f"context {cl + 1} needs {_cdiv(cl + 1, P)}")
        mbp = _pow2(max(_cdiv(cl + 1, P) for cl in cls))
        bp = _pow2(len(dec))
        toks = np.zeros(bp, np.int32)
        cl_p = np.zeros(bp, np.int32)
        bt = np.full((bp, mbp), self.store.trash_row, np.int32)
        for i, r in enumerate(dec):
            toks[i] = r.generated_ids[-1]
            cl_p[i] = cls[i]
            k = min(len(rows[i]), mbp)
            bt[i, :k] = rows[i][:k]
        t0 = time.perf_counter()
        with record_function("superinfer.paged_decode"):
            top = self._decode(self._ids(toks), self._ids(bt),
                               self._ids(cl_p))
        self.decode_launch_wall_s += time.perf_counter() - t0
        self.decode_batches += 1
        self.decode_tokens += len(dec)
        self.attn_launches += len(self._layers)
        return top

    # ------------------------------------------------------------- the model
    def _top2(self, h: torch.Tensor) -> torch.Tensor:
        """Final norm + LM head, then (argmax, top-2 margin) per row, fp32."""
        head = self._head
        h = rms_norm(h, head["final_norm"], self.cfg.rms_eps)
        logits = (h @ head["embed"].T if self.cfg.tie_embeddings
                  else h @ head["lm_head"])
        top2 = logits.float().topk(2, dim=-1).values
        return torch.stack([logits.argmax(dim=-1).float(),
                            top2[..., 0] - top2[..., 1]], dim=-1)

    def _store_kv(self, sh: int, li: int, wrow, woff, k, v) -> None:
        """Write per-token K/V ``(T, Hkv, D)`` of layer ``li`` into shard
        ``sh``'s pool at (row ``wrow``, in-block offset ``woff``), in place:
        a plain scatter, or in the int8 tier the running-scale quantized
        store."""
        pool = self.store.pools[sh]
        if self.store.quantized:
            scales = self.store.scale_shards[sh]
            lrow = torch.full_like(wrow, li)
            quant_store_tokens(pool, scales, wrow, lrow, 0, woff, k)
            quant_store_tokens(pool, scales, wrow, lrow, 1, woff, v)
            return
        pool[wrow, li, 0, woff] = k.to(pool.dtype)
        pool[wrow, li, 1, woff] = v.to(pool.dtype)

    def _context(self, sh: int, li: int, btl, side: int,
                 dtype) -> torch.Tensor:
        """Layer ``li``'s K (side 0) or V (side 1) of shard ``sh``'s pool
        rows ``btl`` (MB,), gathered as ``(1, MB * P, Hkv, D)`` in
        ``dtype``; the int8 tier dequantizes it in fp32 first."""
        pool = self.store.pools[sh]
        n = btl.shape[0] * pool.shape[3]
        hkv, hd = pool.shape[-2], pool.shape[-1]
        ctx = pool[btl, li, side]
        if self.store.quantized:
            ctx = (ctx.float() * self.store.scale_shards[sh][
                btl, li, side][:, None, :, None])
        return ctx.reshape(1, n, hkv, hd).to(dtype)

    def _on_shards(self, *ts: torch.Tensor) -> List[Tuple[torch.Tensor, ...]]:
        """``ts`` on each shard's device (the same tensors where it is
        shard 0's)."""
        return [tuple(t.to(d) for t in ts) for d in self.devices]

    def _residual(self, xs: List[torch.Tensor], parts: List[torch.Tensor],
                  reduce: bool) -> List[torch.Tensor]:
        """Each shard's residual stream plus its branch output; the
        branch's partial sums are all-reduced first when ``reduce``."""
        if reduce:
            parts = spmd.all_reduce(parts, self.mesh, "model")
        return [x + p for x, p in zip(xs, parts)]

    @torch.no_grad()
    def _decode(self, toks, bt, cl) -> torch.Tensor:
        """toks/cl: (B,); bt: (B, MB) pool rows (trash row on padded
        lanes/slots). Per layer and shard: write the new token's K/V into
        its tail block row in place, then one paged-attention launch over
        the whole batch (its int8 mode in the int8 tier)."""
        cfg = self.cfg
        P = self.serving.block_size
        MB = bt.shape[1]
        blk = torch.clamp(cl // P, 0, MB - 1).long()
        wrow = bt.gather(1, blk[:, None])[:, 0].long()
        woff = (cl % P).long()
        on = self._on_shards(toks, bt, cl, wrow, woff)
        xs = [head["embed"][o[0].long()]                     # (B, d)
              for (_, head), o in zip(self._shards, on)]
        for li in range(len(self._layers)):
            parts = []
            for sh, ((layers, _), (_, bt_s, cl_s, wrow_s, woff_s)) in \
                    enumerate(zip(self._shards, on)):
                p = layers[li]
                pos = cl_s[:, None]                          # (B, 1)
                h = rms_norm(xs[sh][:, None], p["ln1"], cfg.rms_eps)
                q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
                k = torch.einsum("bsd,dhk->bshk", h, p["wk"])
                v = torch.einsum("bsd,dhk->bshk", h, p["wv"])
                q = apply_rope(q, pos, cfg.rope_theta)
                k = apply_rope(k, pos, cfg.rope_theta)
                self._store_kv(sh, li, wrow_s, woff_s, k[:, 0], v[:, 0])
                out = paged_attention(
                    q[:, 0].contiguous(), self.store.pools[sh], bt_s,
                    cl_s + 1, layer=li,
                    kv_scales=self.store.scale_shards[sh])
                parts.append(torch.einsum("bhk,hkd->bd", out, p["wo"]))
            xs = self._residual(xs, parts, self.tp_plan.shard_kv)
            parts = []
            for sh, (layers, _) in enumerate(self._shards):
                p = layers[li]
                h2 = rms_norm(xs[sh][:, None], p["ln2"], cfg.rms_eps)
                parts.append(swiglu(h2, p["w_gate"], p["w_up"],
                                    p["w_down"])[:, 0])
            xs = self._residual(xs, parts, self.tp_plan.shard_mlp)
        return self._top2(xs[0])

    @torch.no_grad()
    def _prefill(self, ids, start: int, nvalid: int, bt) -> torch.Tensor:
        """One prefill chunk for one request. ids: (T,) padded chunk token
        ids; start: the chunk's absolute position; nvalid: real chunk
        length; bt: (MB,) the request's pool rows. K/V scatter into the
        assigned rows in place, attention over the gathered block context
        (earlier chunks and shared cache-hit blocks included), per shard.
        Returns (argmax, margin) at the chunk tail (meaningful only when
        the chunk completes the prompt)."""
        cfg = self.cfg
        P = self.serving.block_size
        T = ids.shape[0]
        MB = bt.shape[0]
        tpos = start + torch.arange(T, device=self.device)
        valid = torch.arange(T, device=self.device) < nvalid
        blk = torch.clamp(tpos // P, 0, MB - 1)
        wrow = torch.where(valid, bt.long()[blk],
                           torch.full_like(blk, self.store.trash_row))
        woff = tpos % P
        btl = bt.long()
        on = self._on_shards(ids, tpos, wrow, woff, btl)
        xs = [head["embed"][o[0].long()][None]               # (1, T, d)
              for (_, head), o in zip(self._shards, on)]
        for li in range(len(self._layers)):
            parts = []
            for sh, ((layers, _), (_, tpos_s, wrow_s, woff_s, btl_s)) in \
                    enumerate(zip(self._shards, on)):
                p = layers[li]
                h = rms_norm(xs[sh], p["ln1"], cfg.rms_eps)
                q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
                k = torch.einsum("bsd,dhk->bshk", h, p["wk"])
                v = torch.einsum("bsd,dhk->bshk", h, p["wv"])
                q = apply_rope(q, tpos_s[None], cfg.rope_theta)
                k = apply_rope(k, tpos_s[None], cfg.rope_theta)
                self._store_kv(sh, li, wrow_s, woff_s, k[0], v[0])
                k_ctx = self._context(sh, li, btl_s, 0, k.dtype)
                v_ctx = self._context(sh, li, btl_s, 1, v.dtype)
                out = flash_attention(q.contiguous(), k_ctx, v_ctx,
                                      causal=True, q_offset=start)
                parts.append(torch.einsum("bshk,hkd->bsd", out, p["wo"]))
            xs = self._residual(xs, parts, self.tp_plan.shard_kv)
            parts = []
            for sh, (layers, _) in enumerate(self._shards):
                p = layers[li]
                h2 = rms_norm(xs[sh], p["ln2"], cfg.rms_eps)
                parts.append(swiglu(h2, p["w_gate"], p["w_up"], p["w_down"]))
            xs = self._residual(xs, parts, self.tp_plan.shard_mlp)
        return self._top2(xs[0][0, nvalid - 1])
