"""In-place audit at the paged runner's launch entries.

The port of ``src/repro/launch/audit_donation.py``. The reference asserts
that every jitted entry point of ``PagedModelRunner``/``PagedKVStore``
donates the KV pool: without donation each launch would deep-copy the
whole pool. Eager PyTorch has no donation; the port updates the pool (and
the int8 tier's scales) in place, so the contract becomes: after each
launch entry, the store's buffers are the same storage (``data_ptr()``
unchanged) and hold the call's writes (the rows it writes changed, so no
write went to a copy). On CUDA the call's peak memory growth
(``torch.cuda.max_memory_allocated()`` after
``reset_peak_memory_stats()``) must also stay below one pool's bytes
(``PagedKVStore.pool_global_bytes``): a copy of the pool cannot hide
there.

The entries, in bf16 and in the int8 tier (pool and scales), with the
reference's jit boundary each replaces:

- ``PagedKVStore._copy_rows`` (``_jit_copy``/``_jit_copy_q``): the batched
  row copy that ``run_d2d``, ``run_d2h`` and ``run_h2d`` launch;
- ``PagedKVStore.run_h2d`` (``_jit_upload``/``_jit_upload_q``): the
  host-to-device upload into staging and its scatter into place;
- ``PagedModelRunner._decode`` and ``._prefill`` (``_jit_decode``,
  ``_jit_prefill``).

The tensor-parallel half audits the same entries at tp=2 over a
two-shard mesh (the reference's ``[tp=2]`` boundaries): every shard's pool
and scales must keep their storage and hold the call's writes, and the
growth stays below one shard's pool. ``main`` puts both shards on the
audit's device; ``audit(..., tp2=[...])`` takes any two.

The negative control is an out-of-place row copy,
``pool.index_copy(0, dst, pool[src])``, which returns a new tensor (the
counterpart of the reference's ``kv_copy_tpu`` jitted without donation):
the audit must find it not in place.

    PYTHONPATH=src python -m repro_torch.launch.audit_donation [--device cpu]

Exits non-zero if any entry fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch


class Case(NamedTuple):
    name: str
    reference: str                 # the reference's jit boundary
    run: Callable[[], List[torch.Tensor]]   # the call; buffers after it
    buffers: Callable[[], List[torch.Tensor]]   # the buffers it must write
    rows: Sequence[int]            # rows of each buffer the call writes
    expect_in_place: bool
    prepare: Optional[Callable[[], None]] = None   # set-up before it


@dataclasses.dataclass
class Row:
    name: str
    reference: str
    found: int                     # buffers audited
    in_place: int                  # of them, same storage and written
    growth: Optional[int]          # peak memory growth (CUDA), bytes
    pool_bytes: int
    ok: bool

    @property
    def verdict(self) -> str:
        return "ok" if self.ok else "FAIL"


class _KV:
    """``PagedModelRunner.bind`` needs only the attach hook."""
    table = None

    def attach_data_backend(self, store):
        pass


def _cases(runner, gen) -> List[Case]:
    """The four launch entries of one runner's store and model, named with
    the reference's jit boundary each replaces."""
    from repro_torch.core.blocktable import TransferDesc
    store = runner.store
    dev = store.device
    P = runner.serving.block_size
    q = "_q" if store.quantized else ""
    tag = "".join((f" [tp={runner.tp}]" if runner.tp > 1 else "",
                   " [int8]" if store.quantized else ""))

    def bufs():
        return list(store.pools) + (list(store.scale_shards)
                                    if store.quantized else [])

    def fill(rows):
        """Random values in ``rows`` of every shard's pool (and scales),
        so a copy of them changes its destination."""
        for pool, scales in zip(store.pools, store.scale_shards):
            idx = torch.as_tensor(rows, device=pool.device)
            shape = (len(rows),) + tuple(pool.shape[1:])
            if store.quantized:
                pool[idx] = torch.randint(
                    -127, 128, shape, generator=gen, device=dev,
                    dtype=torch.int32).to(pool.device, torch.int8)
                scales[idx] = (torch.rand(
                    (len(rows),) + tuple(scales.shape[1:]), generator=gen,
                    device=dev) + 0.5).to(pool.device)
            else:
                pool[idx] = torch.randn(shape, generator=gen,
                                        device=dev).to(pool.device,
                                                       pool.dtype)

    def host_row():
        cpu = torch.Generator().manual_seed(int(torch.randint(
            0, 2 ** 31, (1,), generator=gen, device=dev)))
        if store.quantized:
            return (torch.randint(-127, 128, store.row_shape, generator=cpu,
                                  dtype=torch.int32).to(torch.int8),
                    torch.rand(store.scale_row_shape, generator=cpu) + 0.5)
        return torch.randn(store.row_shape, generator=cpu).to(
            store.pool.dtype)

    # copy: rows 0, 1 -> 2, 3
    fill([0, 1])

    def copy():
        store._copy_rows([0, 1], [2, 3])
        return bufs()

    # upload: two host rows -> rows 4, 5 through staging
    store.host[0], store.host[1] = host_row(), host_row()
    descs = [TransferDesc(i, -1, "h2d", i, 4 + i, 0, 1) for i in range(2)]

    def upload():
        store.run_h2d(descs)
        return bufs()

    # prefill: one chunk of ``prefill_chunk`` tokens at position 0 into the
    # rows from 6 on
    T = runner.serving.prefill_chunk
    nb_ctx = -(-T // P)
    ctx_rows = np.arange(6, 6 + nb_ctx, dtype=np.int32)
    ids = np.arange(1, T + 1, dtype=np.int32) % runner.cfg.vocab_size

    def prefill():
        runner._prefill(runner._ids(ids), 0, T, runner._ids(ctx_rows))
        return bufs()

    # decode: two lanes over rows 0..3 at contexts P + 1 and P + 2, which
    # write rows 1 and 3
    bt = np.array([[0, 1], [2, 3]], np.int32)
    cl = np.array([P + 1, P + 2], np.int32)
    toks = np.array([3, 5], np.int32)

    def tiny_scales():
        """The int8 tier's running block scales only grow: make those of
        the rows decode writes tiny, so its token must raise them."""
        for scales in store.scale_shards if store.quantized else ():
            scales[torch.as_tensor([1, 3], device=scales.device)] = 1e-6

    def decode():
        runner._decode(runner._ids(toks), runner._ids(bt), runner._ids(cl))
        return bufs()

    return [
        Case(f"PagedKVStore._copy_rows{tag}",
             f"PagedKVStore._jit_copy{q}{tag}", copy, bufs, [2, 3], True),
        Case(f"PagedKVStore.run_h2d (upload){tag}",
             f"PagedKVStore._jit_upload{q}{tag}", upload, bufs, [4, 5],
             True),
        Case(f"PagedModelRunner._decode{tag}",
             f"PagedModelRunner._jit_decode{tag}", decode, bufs, [1, 3],
             True, tiny_scales),
        Case(f"PagedModelRunner._prefill{tag}",
             f"PagedModelRunner._jit_prefill{tag}", prefill, bufs,
             list(ctx_rows), True),
    ]


def _check(case: Case, pool_bytes: int) -> Row:
    """Run one case; ``pool_bytes`` bounds its peak growth (one pool, one
    shard's under tensor parallelism). On CUDA the growth is the largest
    over the buffers' cards."""
    if case.prepare is not None:
        case.prepare()
    bufs = case.buffers()
    rows = list(case.rows)
    before = [b[torch.as_tensor(rows, device=b.device)].clone()
              for b in bufs]
    ptrs = [b.data_ptr() for b in bufs]
    cards = sorted({b.device for b in bufs if b.device.type == "cuda"},
                   key=str)
    base = {}
    for d in cards:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
        base[d] = torch.cuda.memory_allocated(d)
    out = case.run()
    growth = None
    for d in cards:
        torch.cuda.synchronize(d)
        g = torch.cuda.max_memory_allocated(d) - base[d]
        growth = g if growth is None else max(growth, g)
    in_place = sum(int(o.data_ptr() == p and not torch.equal(
        o[torch.as_tensor(rows, device=o.device)], b))
        for o, p, b in zip(out, ptrs, before))
    found = len(out)
    ok = in_place == (found if case.expect_in_place else 0)
    if case.expect_in_place and growth is not None:
        ok = ok and growth < pool_bytes
    return Row(case.name, case.reference, found, in_place, growth,
               pool_bytes, ok)


def audit(cfg, serving, device, *, seed: int = 0,
          tp2: Optional[Sequence] = None) -> List[Row]:
    """Audit the runner's launch entries for ``cfg`` and ``serving`` on
    ``device`` in the bf16 and the int8 tier; with ``tp2`` (the two
    devices of a tp=2 mesh) the same at tp=2; then the negative control.
    The first runner draws the weights from ``seed``; the others share
    them (sliced at tp=2)."""
    from repro_torch.configs import GH200
    from repro_torch.device import resolve_device
    from repro_torch.serving.paged_runner import PagedModelRunner
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    rows: List[Row] = []
    params = pool = None
    runs = [(1, "bf16", device), (1, "int8", device)]
    if tp2 is not None:
        runs += [(2, "bf16", list(tp2)), (2, "int8", list(tp2))]
    for tp, kvd, dev in runs:
        runner = PagedModelRunner(cfg, dataclasses.replace(
            serving, kv_dtype=kvd, tp=tp), GH200, seed=seed, params=params,
            device=dev)
        if params is None:
            params = {"layers": runner._layers, "head": runner._head}
        runner.bind(_KV())
        for case in _cases(runner, gen):
            rows.append(_check(case, runner.store.pool_shard_bytes))
        if tp == 1:
            pool = runner.store.pool
        del runner
    # negative control: an out-of-place copy of rows 0, 1 into 2, 3
    flat = pool.view(pool.shape[0], -1)
    src = torch.tensor([0, 1], device=device)
    dst = torch.tensor([2, 3], device=device)
    flat[src] = flat[src] + 1           # so the copy changes its rows
    rows.append(_check(Case(
        "kv_copy out of place (negative control)",
        "kv_copy_tpu (no donate — negative control)",
        lambda: [flat.index_copy(0, dst, flat[src])], lambda: [flat], [2, 3],
        False), flat.numel() * flat.element_size()))
    return rows


def print_table(rows: Sequence[Row]) -> None:
    print(f"{'launch entry':48} {'buf arg':>8} {'in place':>8} "
          f"{'growth B':>12} {'pool B':>12}  verdict")
    for r in rows:
        growth = "n/a" if r.growth is None else str(r.growth)
        print(f"{r.name:48} {r.found:>8} {r.in_place:>8} {growth:>12} "
              f"{r.pool_bytes:>12}  {r.verdict}")


def small_config():
    """The reference audit's config: llama3-8b reduced in fp32, 8 HBM
    blocks of 4 tokens, chunks of 8, the pipelined (double-buffered)
    store."""
    from repro_torch.configs import ServingConfig, get_config
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(),
                              dtype="float32")
    sv = ServingConfig(num_hbm_blocks=8, num_dram_blocks=32,
                       scheduler="rotasched", block_size=4, max_model_len=64,
                       prefill_chunk=8, paged_runner=True, pipeline=True)
    return cfg, sv


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' to run there)")
    args = ap.parse_args(argv)
    from repro_torch.device import resolve_device
    tp2 = [resolve_device(args.device)] * 2
    rows = audit(*small_config(), args.device, tp2=tp2)
    print_table(rows)
    print(f"# tp=2 shards on: {', '.join(str(d) for d in tp2)}")
    failures = [r.name for r in rows if not r.ok]
    if failures:
        print(f"# AUDIT FAILED: not in place or unexpectedly in place: "
              f"{', '.join(failures)}", file=sys.stderr)
        return 1
    print("# audit ok: every pool-carrying launch entry updates its pool in "
          "place; the out-of-place control was caught")
    return 0


if __name__ == "__main__":
    sys.exit(main())
