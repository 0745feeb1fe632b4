"""Train a ~100M-parameter dense LM with the PyTorch port for a few
hundred steps on the synthetic packed pipeline, with async checkpointing
and deterministic resume (the port of ``examples/train_100m.py``).

    PYTHONPATH=src python examples/torch/train_100m.py --steps 300
    (defaults to --steps 30; runs on the CUDA card, or pass --device cpu;
     checkpoints go to build/torch_100m_ckpt unless --ckpt-dir says)
"""
import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.launch.train import main as train_main  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", default="30")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=str(ROOT / "build" /
                                              "torch_100m_ckpt"))
    args = ap.parse_args(argv)
    # gemma3-1b narrowed to ~100M params: d_model 512, 12 layers
    return train_main(["--arch", "gemma3-1b", "--width", "512",
                       "--layers", "12", "--steps", args.steps,
                       "--batch", "4", "--seq", "256", "--microbatches", "2",
                       "--moments-dtype", "int8", "--ckpt-dir",
                       args.ckpt_dir, "--ckpt-every", "50", "--log-every",
                       "5", "--device", args.device])


if __name__ == "__main__":
    main()
