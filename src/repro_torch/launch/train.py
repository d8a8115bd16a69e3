"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --steps 50 --ckpt /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu

Port of ``repro.launch.train``: the same flags and defaults, the same
``TokenPipeline`` batches and schedule, and the same loop (the
fault-tolerant one: checkpoints every ``--save-every`` steps, restores
after failures -- and from any checkpoint already under ``--ckpt`` --
and serves a backup batch when the host pipeline misses its deadline).
``--smoke`` runs the reduced config.  The model, its state and the
batches live on ``--device``: the card unless the caller names another.
Weights are random, from a seeded ``torch.Generator``.  Returns the
losses, one per step run.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.table import resolve_device
from repro_torch.data import TokenPipeline
from repro_torch.runtime import CheckpointManager, FaultTolerantLoop
from repro_torch.runtime.fault_tolerance import PrefetchWithBackup
from repro_torch.train.optimizer import cosine_schedule
from repro_torch.train.steps import init_train_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default="/tmp/repro_ckpt")
    ap.add_argument("--save-every", type=int, default=25)
    ap.add_argument("--bits8", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family in ("vlm", "audio"):
        # stub-frontend archs train their backbone on tokens, as the
        # reference's launcher does
        cfg = cfg.scaled(input_kind="tokens")
    pipe = TokenPipeline(cfg.vocab_size, args.seq, args.batch, seed=0)
    lr_fn = cosine_schedule(args.lr, warmup=10, total=args.steps)
    step = make_train_step(cfg, lr_fn, bits8=args.bits8)
    state = init_train_state(cfg, torch.Generator(dev).manual_seed(0),
                             bits8=args.bits8, device=dev)

    ckpt = CheckpointManager(args.ckpt, keep=2)
    loop = FaultTolerantLoop(step_fn=step, ckpt=ckpt,
                             save_every=args.save_every)

    def batches():
        for b in pipe:
            yield {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    t0 = time.time()
    hist_print = {"n": 0}

    def step_logged(state, batch):
        state, m = step(state, batch)
        hist_print["n"] += 1
        if hist_print["n"] % args.log_every == 0:
            print(f"step {hist_print['n']:5d} "
                  f"loss={float(m['loss']):.4f} "
                  f"gnorm={float(m['grad_norm']):.3f} "
                  f"lr={float(m['lr']):.2e} "
                  f"({(time.time()-t0)/hist_print['n']:.2f}s/step)")
        return state, m

    loop.step_fn = step_logged
    src = PrefetchWithBackup(batches(), deadline_s=30.0)
    state, history, recoveries = loop.run(state, src, args.steps)
    losses = [float(m["loss"]) for m in history]
    print(f"done: {len(history)} steps, loss {losses[0]:.3f} -> "
          f"{losses[-1]:.3f}, recoveries={recoveries}, "
          f"stale_batches={src.stale_served}")
    return losses


if __name__ == "__main__":
    main()
