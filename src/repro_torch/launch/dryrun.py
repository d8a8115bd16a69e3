"""Multi-pod dry run: lay out every (architecture x input shape) cell on
the production meshes and count what a step needs, on ``meta`` tensors.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
        --shape train_4k [--multi-pod] [--bits8] [--opt]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

Port of ``repro.launch.dryrun``: the same cells (``ARCH_IDS`` x
``SHAPES`` where ``shape_applicable`` allows), flags and record keys.
The production mesh (256 or 512 entries) is forced onto entries naming
``meta`` (``parallel.mesh.force_local_devices``), every state, batch
and cache is a ``meta`` stand-in (``launch.specs``), and the step runs
on them: nothing is allocated and no card is needed.  One JSON record
per cell goes to ``--out`` (default ``build/dryrun_torch/``).

The reference lowers and compiles each cell with XLA's SPMD
partitioner; torch has none.  So each field of the record is one of:

* **equal to the reference's** -- ``arch``, ``shape``, ``kind``,
  ``mesh``, ``n_chips``, ``bits8``, ``opt``, ``params_total`` (the
  reference's ``param_count``, which undercounts the hybrid and
  estimates xLSTM: ROADMAP queue 3 item 5), ``params_active`` and
  ``model_flops``;
* **computed another way**, named in the record's ``method`` map --
  ``argument_bytes_per_device`` (each state and batch leaf's bytes over
  the product of its spec's mesh-axis sizes), ``flops_counted``
  (``torch.utils.flop_counter.FlopCounterMode`` over the port's own
  step at full depth, the whole global batch; the counter counts
  matrix products and attention, not elementwise work; at qwen3-1.7b's
  widths XLA's count of the same step is 0.3-1.0% higher for train,
  prefill and a float32 decode, and in a bfloat16 decode it also counts
  the converts around every dot, which the port does not do per call) and
  ``flops_counted_per_device`` (an even split over the chips);
* **absent**, recorded as ``null`` with the reason in ``notes`` --
  ``hlo_flops``, ``hlo_bytes`` and their ``_raw`` forms,
  ``collective_bytes``, ``collective_total``,
  ``output_bytes_per_device``, ``temp_bytes_per_device``,
  ``peak_bytes_per_device``, ``lower_s`` and ``compile_s``.

These records are not a benchmark cell, and nothing in the repo reads
them; the reference's records (``benchmarks/dryrun/``) are its own.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
import traceback
from typing import Dict, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.config import active_param_count, param_count
from repro_torch.parallel import sharding as shardlib
from repro_torch.parallel.mesh import force_local_devices
from repro_torch.train.steps import make_serve_steps, value_and_grad

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "dryrun_torch"

ABSENT = ("hlo_flops", "hlo_bytes", "hlo_flops_raw", "hlo_bytes_raw",
          "collective_bytes", "collective_total", "output_bytes_per_device",
          "temp_bytes_per_device", "peak_bytes_per_device", "lower_s",
          "compile_s")
NOTES = {
    "hlo": "no SPMD compiler: torch reports no HLO cost analysis "
           "(hlo_flops, hlo_bytes and their _raw forms)",
    "collectives": "no SPMD partitioner inserts collectives, so there "
                   "are none to count (collective_bytes, "
                   "collective_total)",
    "memory": "no compiled program: output, temporary and peak bytes "
              "per device are a compiler's memory analysis",
    "timing": "nothing is lowered or compiled (lower_s, compile_s)",
}
METHOD = {
    "argument_bytes_per_device":
        "sum over the state's and batch's leaves of the leaf's bytes "
        "divided by the product of its spec's mesh-axis sizes",
    "flops_counted":
        "torch.utils.flop_counter.FlopCounterMode over the port's step on "
        "meta tensors at full depth and the whole global batch (train: "
        "loss, remat recompute and backward; clip and AdamW are "
        "elementwise, which the counter does not count)",
    "flops_counted_per_device": "flops_counted / n_chips (an even split)",
}


def _spec_bytes(leaf, spec: shardlib.P, mesh) -> int:
    parts = 1
    for dim in range(len(spec)):
        for a in spec.mesh_axes(dim):
            parts *= mesh.shape[a]
    shape = shardlib.leaf_shape(leaf)
    t = leaf[0] if isinstance(leaf, list) else leaf
    n = 1
    for s in shape:
        n *= s
    return n * t.element_size() // parts


def _state_bytes(tree, mesh) -> int:
    """Per-device bytes of a state tree placed by the path rules (under
    the active mesh)."""
    return sum(_spec_bytes(leaf, shardlib.spec_for_path(
        shardlib._path_str(path), shardlib.leaf_shape(leaf)), mesh)
        for path, leaf in shardlib.leaves_with_paths(tree))


def _dict_bytes(tensors: Dict, shardings: Dict, mesh) -> int:
    """Per-device bytes of a dict of tensors and their placements."""
    return sum(_spec_bytes(t, shardings[k].spec, mesh)
               for k, t in tensors.items())


def _count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def _opt_cfg(cfg, kind: str):
    """The ``--opt`` variant: bf16 weights and head-padded attention;
    serving also stores a GQA-repeated, head-sharded KV cache when
    ``q_rep <= 2``."""
    if kind == "train":
        return cfg.scaled(param_dtype="bfloat16", pad_attn_heads=True)
    return cfg.scaled(param_dtype="bfloat16", pad_attn_heads=True,
                      cache_repeated_kv=cfg.q_rep <= 2)


def countable(cfg, kind: str) -> bool:
    """Whether the step's FLOPs are counted.  xLSTM's sLSTM is a Python
    loop over the positions (``models.layers.slstm_scan``), and meta
    tensors run their elementwise ops through Python reference kernels:
    counting xlstm-350m's train step on meta takes ~0.36 s per position
    on a host CPU (measured at 128-512 positions), so ~25 minutes at
    4,096 and hours for a 32k prefill.  Its train and prefill cells
    are laid out and not counted; its one-token decode is counted."""
    return cfg.family != "ssm" or kind == "decode"


def _measure(cfg, shape_name: str, mesh, kind: str, bits8: bool,
             measure: bool) -> Dict:
    """(argument bytes per device, counted FLOPs or None) of one cell,
    under the active mesh."""
    seq, gbatch, _ = SHAPES[shape_name]
    if kind == "train":
        state = S.abstract_train_state(cfg, bits8=bits8)
        batch = S.input_specs(cfg, shape_name)
        args = (_state_bytes(state, mesh)
                + _dict_bytes(batch, S.batch_shardings(mesh, batch), mesh))
        run = lambda: value_and_grad(state.params, cfg, batch)  # noqa: E731
    else:
        params = S.abstract_params(cfg)
        arg_params = _state_bytes(params, mesh)
        prefill_step, decode_one = make_serve_steps(cfg, seq)
        if kind == "prefill":
            batch = S.input_specs(cfg, shape_name)
            batch.pop("labels", None)
            args = arg_params + _dict_bytes(
                batch, S.batch_shardings(mesh, batch), mesh)
            run = lambda: prefill_step(params, batch)  # noqa: E731
        else:
            specs = S.decode_specs(cfg, shape_name)
            tokens = {"tokens": specs["tokens"]}
            args = (arg_params
                    + _dict_bytes(tokens, S.batch_shardings(mesh, tokens),
                                  mesh)
                    + _dict_bytes(specs["cache"], S.cache_shardings(
                        mesh, cfg, specs["cache"]), mesh)
                    + specs["pos"].element_size())
            # the port's decode takes the position as a host int; the
            # step's work does not depend on it
            run = lambda: decode_one(  # noqa: E731
                params, specs["tokens"], specs["cache"], seq - 1)
    t0 = time.perf_counter()
    flops = _count(run) if measure and countable(cfg, kind) else None
    return {"args": args, "flops": flops,
            "count_s": time.perf_counter() - t0}


def model_flops(cfg, shape_name: str) -> float:
    """The reference's model FLOPs of a cell: 6 (train) or 2 (serve) x
    active parameters x tokens, plus the attention reads of decode."""
    seq, gbatch, kind = SHAPES[shape_name]
    tokens = gbatch * (seq if kind != "decode" else 1)
    n_active = active_param_count(cfg)
    flops = (6 if kind == "train" else 2) * n_active * tokens
    if kind == "decode":
        s_ctx = min(seq, cfg.sliding_window) if cfg.sliding_window else seq
        if cfg.family not in ("ssm",):
            flops += 4 * cfg.n_layers * s_ctx * (cfg.n_heads * cfg.hd) \
                * gbatch
    return float(flops)


def cell_tag(arch: str, shape_name: str, multi_pod: bool, bits8: bool,
             opt: bool) -> str:
    return (f"{arch}_{shape_name}_{'2x16x16' if multi_pod else '16x16'}"
            + ("_8bit" if bits8 else "") + ("_opt" if opt else ""))


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             bits8: bool = False, save: bool = True, measure: bool = True,
             opt: bool = False, out: Optional[pathlib.Path] = None) -> Dict:
    cfg = get_config(arch)
    ok, note = shape_applicable(cfg, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": True,
                "note": note}
    n = 512 if multi_pod else 256
    with force_local_devices([S.META] * n):
        mesh = make_production_mesh(multi_pod=multi_pod)
    seq, gbatch, kind = SHAPES[shape_name]
    rules = (shardlib.SERVE_RULES if (opt and kind != "train")
             else shardlib.DEFAULT_RULES)
    run_cfg = _opt_cfg(cfg, kind) if opt else cfg
    with shardlib.activate(mesh, rules):
        got = _measure(run_cfg, shape_name, mesh, kind, bits8, measure)
    n_chips = mesh.size
    rec = {
        "arch": arch, "shape": shape_name, "kind": kind,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_chips": n_chips, "bits8": bits8, "opt": opt,
        **{k: None for k in ABSENT},
        "argument_bytes_per_device": got["args"],
        "flops_counted": None if got["flops"] is None
        else float(got["flops"]),
        "flops_counted_per_device": None if got["flops"] is None
        else got["flops"] / n_chips,
        "params_total": param_count(cfg),
        "params_active": active_param_count(cfg),
        "model_flops": model_flops(cfg, shape_name),
        "count_s": got["count_s"],
        "method": METHOD,
        "notes": dict(NOTES, **({} if got["flops"] is not None else {
            "flops_counted": "--no-measure: no step was counted"
            if not measure else "the sLSTM's loop over positions is "
            "too slow to count on meta (dryrun.countable)"})),
    }
    if save:
        out = pathlib.Path(out or OUT_DIR)
        out.mkdir(parents=True, exist_ok=True)
        tag = cell_tag(arch, shape_name, multi_pod, bits8, opt)
        (out / f"{tag}.json").write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--bits8", action="store_true")
    ap.add_argument("--opt", action="store_true",
                    help="beyond-paper optimised variant (bf16 weights, "
                         "head padding, serve-mode sharding)")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--no-measure", action="store_true",
                    help="lay out each cell without counting its FLOPs")
    ap.add_argument("--out", default=None,
                    help=f"record directory (default {OUT_DIR})")
    args = ap.parse_args(argv)
    out = pathlib.Path(args.out) if args.out else OUT_DIR

    cells = []
    for arch in ([args.arch] if args.arch else ARCH_IDS):
        arch = arch.replace("-", "_").replace(".", "_")
        for shape in ([args.shape] if args.shape else SHAPES):
            cells.append((arch, shape))

    failures, records = [], []
    for arch, shape in cells:
        tag = cell_tag(arch, shape, args.multi_pod, args.bits8, args.opt)
        if args.skip_existing and (out / f"{tag}.json").exists():
            print(f"[skip existing] {tag}")
            continue
        try:
            rec = run_cell(arch, shape, multi_pod=args.multi_pod,
                           bits8=args.bits8, opt=args.opt,
                           measure=not args.no_measure, out=out)
            records.append(rec)
            if rec.get("skipped"):
                print(f"[skipped] {arch} {shape}: {rec['note']}")
            else:
                flops = rec["flops_counted"]
                gib = rec["argument_bytes_per_device"] / 2**30
                print(f"[ok] {arch} {shape} {rec['mesh']}: flops="
                      + ("not counted" if flops is None else f"{flops:.3e}")
                      + f" args/dev={gib:.2f}GiB count={rec['count_s']:.1f}s")
        except Exception as e:   # a cell that fails is reported, not fatal
            failures.append((arch, shape, repr(e)))
            print(f"[FAIL] {arch} {shape}: {e!r}")
            traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} cells failed: "
                         + ", ".join(f"{a}/{s}" for a, s, _ in failures))
    print(f"all requested cells laid out; records in {out}")
    return records


if __name__ == "__main__":
    main()
