"""Serving launcher: batched decode with the predictive prefix cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

Port of ``repro.launch.serve``: the same flags and defaults, the same
seeded prompts drawn in the same order, and the same scheduler and
prefix-cache settings, so ``served``, ``covered_tokens`` and the cache's
entries equal the reference's (the scheduler stops on the token budget
alone, so they do not depend on the model's numbers).  The model and
the cache's forecaster states live on ``--device``: the card unless the
caller names another.  Weights are random, from a seeded
``torch.Generator``.

Demonstrates the paper's technique in the serving stack: recurring
prompt prefixes are detected, their utility forecast, and their KV
spans materialised incrementally ahead of the traffic that needs them.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.table import resolve_device
from repro_torch.models import init_params
from repro_torch.serving import BatchScheduler, PredictivePrefixCache
from repro_torch.train.steps import make_serve_steps


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.input_kind == "embeds":
        cfg = cfg.scaled(input_kind="tokens")
    s_max = args.prompt_len + args.new_tokens
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    prefill_step, decode_one = make_serve_steps(cfg, s_max)

    rng = np.random.default_rng(0)
    # two recurring system prefixes + random tails
    prefixes = {f"sys{i}": rng.integers(
        1, cfg.vocab_size, args.prompt_len // 2).astype(np.int32)
        for i in range(2)}
    sched = BatchScheduler(max_batch=args.batch)
    cache_mgr = PredictivePrefixCache(
        hbm_budget_bytes=50e6,
        bytes_per_token=2.0 * cfg.n_layers * cfg.n_kv_heads * cfg.hd * 2,
        tokens_per_cycle=args.prompt_len, device=dev)

    for i in range(args.requests):
        pid = f"sys{i % 2}"
        tail = rng.integers(1, cfg.vocab_size,
                            args.prompt_len - len(prefixes[pid]))
        prompt = np.concatenate([prefixes[pid], tail]).astype(np.int32)
        sched.submit(prompt, max_new_tokens=args.new_tokens, prefix_id=pid)

    served, covered_tokens = 0, 0
    t0 = time.time()
    while not sched.idle:
        newly = sched.admit()
        for r in newly:
            covered = cache_mgr.lookup(r.prefix_id, len(prefixes[r.prefix_id]))
            covered_tokens += covered
            batch = {"tokens": torch.from_numpy(r.prompt[None, :]).to(dev)}
            tok, cache = prefill_step(params, batch)
            pos = len(r.prompt)
            t = tok
            for _ in range(r.max_new_tokens):
                sched.record_tokens({r.rid: int(t[0])})
                if r.done:
                    break
                t, cache = decode_one(params, t[:, None], cache, pos)
                pos += 1
            served += 1
        cache_mgr.cycle()
    dt = time.time() - t0
    print(f"served {served} requests in {dt:.1f}s; prefix cache covered "
          f"{covered_tokens} prompt tokens across admissions; "
          f"cache entries={len(cache_mgr.entries)}")
    return served, covered_tokens


if __name__ == "__main__":
    main()
