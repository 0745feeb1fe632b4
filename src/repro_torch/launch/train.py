"""Training launcher: config -> data -> train loop with checkpoints,
deterministic resume, and an iteration watchdog (straggler telemetry).

The port of ``src/repro/launch/train.py``, with the same flags and prints,
plus ``--device`` (default ``cuda``; with no CUDA device only ``--device
cpu`` runs). Weights are drawn from ``torch.Generator(device)`` seeded with
``--seed`` (on a mesh: on its first device, then placed, so a mesh trains
the weights of the run without one). ``--mesh D,M`` trains any config on
a ``(data, model)`` mesh (``launch.mesh.make_mesh``): ``--device cpu`` puts
every shard on the CPU, a comma-separated list of ``D·M`` devices is taken
as given (``cuda:0,cuda:0,cuda:0,cuda:0`` stacks four shards on one
card), and ``cuda`` needs ``D·M`` cards. ``--resume`` restores onto the
mesh of this run, whatever mesh saved the checkpoint. The data is
``SyntheticPacked``'s tokens, as the reference launcher's, so a config
with a frontend or an encoder fails for want of its ``embeds`` or
``src_embeds`` with a mesh as without one.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
        --reduced --steps 50 --batch 8 --seq 128 --ckpt-dir build/ckpt \\
        --ckpt-every 20 --device cpu [--mesh 2,2]
"""
from __future__ import annotations

import argparse
import dataclasses
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced (CPU-sized) config")
    ap.add_argument("--width", type=int, default=0,
                    help="override d_model (build ~100M-class models)")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--moments-dtype", default="float32",
                    choices=["float32", "bfloat16", "int8"])
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh", default="", help="e.g. '2,2' => (data,model)")
    ap.add_argument("--watchdog-factor", type=float, default=3.0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default), 'cpu', or with --mesh a "
                         "comma-separated list of one device a shard")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import Prefetcher, SyntheticPacked
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.lm import LM
    from repro_torch.optimizer.adamw import AdamWConfig
    from repro_torch.training import step as steplib

    mesh = None
    if args.mesh:
        shape = tuple(int(x) for x in args.mesh.split(","))
        devs = args.device.split(",") if "," in args.device else args.device
        mesh = make_mesh(shape, ("data", "model")[:len(shape)], devs)
        device = mesh.devices[0]
    else:
        device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.width:
        cfg = dataclasses.replace(cfg, d_model=args.width)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)

    lm = LM(cfg)
    opt_cfg = AdamWConfig(lr=args.lr, moments_dtype=args.moments_dtype)
    train_step = steplib.make_train_step(lm, opt_cfg,
                                         microbatches=args.microbatches,
                                         mesh=mesh)
    where = (f"mesh {dict(mesh.shape)} on {sorted(set(map(str, mesh.devices)))}"
             if mesh is not None else str(device))
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"devices={mesh.size if mesh is not None else 1} ({where})")

    data = SyntheticPacked(cfg.vocab_size, args.seq, args.batch,
                           seed=args.seed)
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None

    state = steplib.init_train_state(
        lm, torch.Generator(device=device).manual_seed(args.seed), opt_cfg,
        device, mesh=mesh)
    start = 0
    if ckpt and args.resume and ckpt.latest_step() is not None:
        start = ckpt.latest_step()
        state = ckpt.restore(start, state, device, mesh=mesh)
        data.skip_to(start)
        print(f"resumed from step {start}")

    it = Prefetcher(iter(data))
    ema = None
    losses = []
    for step_i in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in next(it).items()}
        for k in ("tokens", "labels"):
            batch[k] = batch[k].long()
        t0 = time.time()
        state, metrics = train_step(state, batch)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        # watchdog: flag straggler iterations
        if ema is not None and dt > args.watchdog_factor * ema:
            print(f"[watchdog] step {step_i} took {dt*1e3:.0f}ms "
                  f"({dt/ema:.1f}x EMA) — straggler")
        ema = dt if ema is None else 0.9 * ema + 0.1 * dt
        losses.append(loss)
        if step_i % args.log_every == 0:
            print(f"step {step_i:5d} loss {loss:.4f} "
                  f"({dt*1e3:.0f} ms, grad_norm "
                  f"{float(metrics['grad_norm']):.3f})")
        if ckpt and (step_i + 1) % args.ckpt_every == 0:
            ckpt.save(step_i + 1, state, async_=True)
    if ckpt:
        ckpt.save(args.steps, state)
        ckpt.wait()
    it.close()
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
