"""Quickstart with the PyTorch port: build a model from the arch registry,
train a few steps, then prefill + decode a continuation, with a reduced
config (the port of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch/quickstart.py [--arch yi-34b]
    (runs on the CUDA card, or pass --device cpu)
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models.api import make_demo_inputs  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.optimizer.adamw import AdamWConfig  # noqa: E402
from repro_torch.training import step as steplib  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-34b")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    lm = LM(cfg)
    print(f"{cfg.name}: {cfg.param_count()/1e6:.2f}M params, "
          f"{cfg.num_layers} layers ({cfg.family}) on {device}")

    # --- a few training steps -------------------------------------------------
    opt = AdamWConfig(lr=3e-3, warmup_steps=2)
    train_step = steplib.make_train_step(lm, opt, microbatches=2)
    state = steplib.init_train_state(
        lm, torch.Generator(device=device).manual_seed(0), opt, device)
    batch = make_demo_inputs(cfg, ShapeConfig("t", 64, 4, "train"),
                             device=device)
    losses = []
    for i in range(args.steps):
        state, metrics = train_step(state, batch)
        losses.append(float(metrics["loss"]))
        if i % 2 == 0:
            print(f"  step {i}: loss {losses[-1]:.4f}")

    # --- generate -----------------------------------------------------------------
    prompt = torch.tensor([[5, 17, 42, 7, 99, 3, 12, 8]], device=device)
    logits, caches = lm.prefill(state.params, {"tokens": prompt}, capacity=32)
    toks = [int(logits[0].argmax())]
    for i in range(10):
        logits, caches = lm.decode_step(
            state.params, caches,
            {"token": torch.tensor([toks[-1]], device=device),
             "cache_len": prompt.shape[1] + i})
        toks.append(int(logits[0].argmax()))
    print("generated token ids:", toks)
    return losses, toks


if __name__ == "__main__":
    main()
