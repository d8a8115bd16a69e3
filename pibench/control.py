"""The control of the check that decides ``correct``.

The control is the plain reference put in the program's place and
computed one precision below what the configurations state: scans
summed in float32 instead of exact integer arithmetic.  It answers the
cell's own statement stream at the cell's own size, and the comparison
``correct`` rests on has to find it wrong.  Run on the card:

    python3 pibench/control.py --workload <cell> --seeds 1 2 3 \
        --statements 4000

It prints, per seed, the numbers the benchmark compares (the control's
answers against the exact reference's) as one JSON line each.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:1] = [str(ROOT)]

import torch  # noqa: E402

from pibench import datagen, harness, spec  # noqa: E402
from pibench.reference.serial_store import SerialStore  # noqa: E402
from pibench.traffic import Traffic  # noqa: E402


def stream(cell, seed: int, n: int, device):
    """The cell's first ``n`` statements for ``seed``, drawn as a run
    draws them (the quantiles of the seed's own table)."""
    cfg = cell.config
    store = SerialStore(2, int(cfg["n_rows"]), device, 1)
    datagen.fill_columns(store.plane, 2, int(cfg["n_rows"]), seed)
    q = datagen.quantile_sample(store.plane(1))
    del store
    gen = Traffic(cell.traffic, int(cfg["n_attrs"]), q, seed)
    k = -(-n // gen.seg_len)
    return [s for i in range(k) for _, s in gen.segment(i)]


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--statements", type=int, required=True)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    device = "cuda:0" if torch.cuda.is_available() else "cpu"
    for seed in args.seeds:
        sent = stream(cell, seed, args.statements, device)
        exact, final = harness.reference_answers(cell.config, seed, sent,
                                                 device)
        ctrl, ctrl_final = harness.reference_answers(
            cell.config, seed, sent, device, agg_dtype=torch.float32)
        answered = [(a[0], a[1], 0) if s.kind == "scan" else (0, 0, a)
                    for s, a in zip(sent, ctrl)]
        checks = harness.compare(sent, answered, exact, ctrl_final, final)
        print(json.dumps(dict(cell=cell.name, seed=seed,
                              statements=len(sent), device=str(device),
                              checks={k: v["value"]
                                      for k, v in checks.items()})))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
