"""Training example on the PyTorch port: train a reduced qwen3-family
model for a few hundred steps on the synthetic pipeline with
checkpointing and fault-tolerant restart, on the card.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 300]
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu

The published configs take the same path without ``--smoke``
(``python -m repro_torch.launch.train --arch qwen3-1.7b``).
"""
import argparse
import tempfile

from repro_torch.launch.train import main as train_main

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    device = [] if args.device is None else ["--device", args.device]
    with tempfile.TemporaryDirectory() as ckpt:
        losses = train_main([
            "--arch", args.arch, "--smoke",
            "--steps", str(args.steps),
            "--batch", "16", "--seq", "128",
            "--ckpt", ckpt,
            "--save-every", "50", *device,
        ])
    assert losses[-1] < losses[0], "training must reduce loss"
    print("OK: loss decreased", losses[0], "->", losses[-1])
