"""The port's dry run (``repro_torch.launch.dryrun``) held to the
reference's on the CPU.

* The exact fields of every cell's record equal those of the
  reference's ``run_cell``, run with its compile replaced by an empty
  cost and memory analysis (they come from the config, not the
  compile).
* ``argument_bytes_per_device`` equals the same arithmetic over the
  reference's own specs and ``eval_shape`` stand-ins.
* ``flops_counted`` (``FlopCounterMode`` on ``meta``) is within 2% of
  the reference's single-device ``cost_analysis()["flops"]`` at
  qwen3-1.7b's published widths with 2 unrolled layers for a train step
  at batch 2 x 512, a prefill of 4,096 positions and a decode step
  against 4,096 cached positions (decode in float32, so that XLA counts
  no per-call cast of the masters).
* The launcher writes one record per applicable cell, with every field
  it cannot compute ``null`` and named in ``notes``.
"""

import _torch_threads  # noqa: F401  (first: pins torch's threads)

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AbstractMesh

import repro.configs as RC
from repro.launch import specs as R_specs
from repro.models import decode_step as R_decode
from repro.models import prefill as R_prefill
from repro.parallel import sharding as R_sh
from repro.train.optimizer import cosine_schedule as R_cosine
from repro.train.steps import make_train_step as R_make_train_step
from repro_torch.configs import SHAPES
from repro_torch.launch import dryrun as D
from repro_torch.models.config import ModelConfig

jax.devices()   # the backend starts here, before the import below
_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as R_dry  # noqa: E402  (sets XLA_FLAGS)
if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

FLOP_TOL = 0.02
MESHES = {False: {"data": 16, "model": 16},
          True: {"pod": 2, "data": 16, "model": 16}}
EXACT = ("arch", "shape", "kind", "mesh", "n_chips", "bits8", "opt",
         "params_total", "params_active", "model_flops")


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.size = 1
        for v in shape.values():
            self.size *= v


def _cells():
    for arch in RC.ARCH_IDS:
        for shape in RC.SHAPES:
            yield arch, shape


@pytest.fixture
def ref_run_cell(monkeypatch):
    """The reference's ``run_cell`` with no lowering or compile: its
    mesh a ``FakeMesh`` of the production shape, its measurement an
    empty cost and memory analysis."""
    def measure(*a, **k):
        return {"cost": {}, "mem": None, "coll": {}, "t_lower": 0.0,
                "t_compile": 0.0}

    monkeypatch.setattr(R_dry, "_measure", measure)
    monkeypatch.setattr(R_dry, "make_production_mesh",
                        lambda multi_pod=False: FakeMesh(MESHES[multi_pod]))
    return R_dry.run_cell


def test_exact_fields_match_the_reference_for_every_cell(ref_run_cell):
    keys = None
    for arch, shape in _cells():
        for multi_pod, bits8, opt in ((False, False, False),
                                      (True, False, False),
                                      (False, True, False),
                                      (False, False, True)):
            ref = ref_run_cell(arch, shape, multi_pod=multi_pod, bits8=bits8,
                               opt=opt, save=False)
            got = D.run_cell(arch, shape, multi_pod=multi_pod, bits8=bits8,
                             opt=opt, save=False, measure=False)
            if ref.get("skipped"):
                assert got == ref
                continue
            for k in EXACT:
                assert got[k] == ref[k], (arch, shape, k)
            keys = set(ref)
            assert keys <= set(got), keys - set(got)
            for k in D.ABSENT:
                assert got[k] is None
            assert got["flops_counted"] is None
            assert set(got["method"]) == {"argument_bytes_per_device",
                                          "flops_counted",
                                          "flops_counted_per_device"}
    assert keys is not None


def _ref_bytes(tree, shardings, mesh_shape):
    total = 0
    for leaf, placed in zip(jax.tree.leaves(tree), jax.tree.leaves(
            shardings, is_leaf=lambda x: hasattr(x, "spec"))):
        parts = 1
        for e in placed.spec:
            for a in (e if isinstance(e, tuple) else (e,)):
                if a is not None:
                    parts *= mesh_shape[a]
        total += int(np.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize \
            // parts
    return total


def _ref_argument_bytes(arch, shape, multi_pod, bits8, opt):
    """The reference's ``in_shardings`` arguments of the cell's step, as
    ``_train_lowered`` / ``_serve_lowered`` build them, per device."""
    cfg = RC.get_config(arch)
    seq, gbatch, kind = RC.SHAPES[shape]
    shape_of = MESHES[multi_pod]
    mesh = AbstractMesh(tuple(shape_of.values()), tuple(shape_of))
    rules = R_sh.SERVE_RULES if (opt and kind != "train") \
        else R_sh.DEFAULT_RULES
    with R_sh.activate(mesh, rules):
        if kind == "train":
            if opt:
                cfg = cfg.scaled(param_dtype="bfloat16", pad_attn_heads=True)
            state = R_specs.abstract_train_state(cfg, bits8=bits8)
            batch = R_specs.input_specs(cfg, shape)
            return (_ref_bytes(state, R_sh.tree_shardings(mesh, state),
                               shape_of)
                    + _ref_bytes(batch, R_specs.batch_shardings(mesh, batch),
                                 shape_of))
        if opt:
            cfg = cfg.scaled(param_dtype="bfloat16", pad_attn_heads=True,
                             cache_repeated_kv=cfg.q_rep <= 2)
        params = R_specs.abstract_params(cfg)
        total = _ref_bytes(params, R_sh.tree_shardings(mesh, params),
                           shape_of)
        if kind == "prefill":
            batch = R_specs.input_specs(cfg, shape)
            batch.pop("labels", None)
            return total + _ref_bytes(
                batch, R_specs.batch_shardings(mesh, batch), shape_of)
        specs = R_specs.decode_specs(cfg, shape)
        tok = {"tokens": specs["tokens"]}
        return (total
                + _ref_bytes(tok, R_specs.batch_shardings(mesh, tok),
                             shape_of)
                + _ref_bytes(specs["cache"], R_specs.cache_shardings(
                    mesh, cfg, specs["cache"]), shape_of)
                + 4)


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_argument_bytes_match_reference_specs(arch):
    for shape in RC.SHAPES:
        if not RC.shape_applicable(RC.get_config(arch), shape)[0]:
            continue
        for multi_pod, bits8, opt in ((False, False, False),
                                      (True, False, False),
                                      (False, True, False),
                                      (True, False, True)):
            got = D.run_cell(arch, shape, multi_pod=multi_pod, bits8=bits8,
                             opt=opt, save=False, measure=False)
            want = _ref_argument_bytes(arch, shape, multi_pod, bits8, opt)
            assert got["argument_bytes_per_device"] == want, \
                (arch, shape, multi_pod, bits8, opt)


# ---------------------------------------------------------------------------
# Counted FLOPs against XLA's
# ---------------------------------------------------------------------------

def _qwen3_2l():
    rcfg = RC.get_config("qwen3_1_7b").scaled(n_layers=2, unroll_layers=True)
    return rcfg, ModelConfig(**dataclasses.asdict(rcfg))


def _xla_flops(fn, *args):
    cost = jax.jit(fn).lower(*args).compile().cost_analysis()
    return float(cost["flops"])


def _port_flops(monkeypatch, pcfg, name, seq, batch, kind):
    monkeypatch.setitem(SHAPES, name, (seq, batch, kind))
    one = FakeMesh({"data": 1, "model": 1})   # one device
    return D._measure(pcfg, name, one, kind, False, True)["flops"]


def test_train_flops_within_2_percent_of_xla(monkeypatch):
    rcfg, pcfg = _qwen3_2l()
    monkeypatch.setitem(RC.SHAPES, "t", (512, 2, "train"))
    state = R_specs.abstract_train_state(rcfg)
    batch = R_specs.input_specs(rcfg, "t")
    step = R_make_train_step(rcfg, R_cosine(3e-4, 100, 10_000))
    want = _xla_flops(step, state, batch)
    got = _port_flops(monkeypatch, pcfg, "t", 512, 2, "train")
    assert abs(got / want - 1) < FLOP_TOL, (got, want)


def test_prefill_flops_within_2_percent_of_xla(monkeypatch):
    rcfg, pcfg = _qwen3_2l()
    monkeypatch.setitem(RC.SHAPES, "p", (4096, 1, "prefill"))
    batch = R_specs.input_specs(rcfg, "p")
    batch.pop("labels")

    def prefill_step(p, b):
        logits, cache = R_prefill(p, rcfg, b, s_max=4096)
        return jnp.argmax(logits, -1).astype(jnp.int32), cache

    want = _xla_flops(prefill_step, R_specs.abstract_params(rcfg), batch)
    got = _port_flops(monkeypatch, pcfg, "p", 4096, 1, "prefill")
    assert abs(got / want - 1) < FLOP_TOL, (got, want)


def test_decode_flops_within_2_percent_of_xla(monkeypatch):
    """A decode step against 4,096 cached positions, held like for like:
    both sides in float32 compute with float32 masters, so XLA counts no
    cast.  The count is exactly the step's matrix products (every weight
    once per token, the head, q.k and p.v over the cache), and XLA's is
    that plus the elementwise work (softmax, norms, RoPE).  In bfloat16
    compute XLA's CPU count is 1.64x the matrix products, and all but
    about 8e3 of the difference is converts, one FLOP per element: every
    master to bfloat16 on each call and, since the CPU's dots run in
    float32, back, and the bfloat16 cache to float32 and back.  The
    port casts its masters once at load."""
    rcfg, _ = _qwen3_2l()
    rcfg = rcfg.scaled(dtype="float32", param_dtype="float32")
    pcfg = ModelConfig(**dataclasses.asdict(rcfg))
    S, B = 4096, 2
    monkeypatch.setitem(RC.SHAPES, "d", (S, B, "decode"))
    specs = R_specs.decode_specs(rcfg, "d")

    def decode_one(p, tok, cache, pos):
        logits, cache = R_decode(p, rcfg, tok, cache, pos)
        return jnp.argmax(logits, -1).astype(jnp.int32), cache

    want = _xla_flops(decode_one, R_specs.abstract_params(rcfg),
                      specs["tokens"], specs["cache"], specs["pos"])
    got = _port_flops(monkeypatch, pcfg, "d", S, B, "decode")
    d, H, KV, hd = rcfg.d_model, rcfg.n_heads, rcfg.n_kv_heads, rcfg.hd
    weights = rcfg.n_layers * (2 * d * H * hd + 2 * d * KV * hd
                               + 3 * d * rcfg.d_ff) + d * rcfg.vocab_size
    attn = rcfg.n_layers * 2 * (2 * H * hd * S)
    assert got == B * (2 * weights + attn)
    assert abs(got / want - 1) < FLOP_TOL, (got, want)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def test_launcher_writes_one_record_per_applicable_cell(tmp_path, capsys):
    out = tmp_path / "dry"
    recs = D.main(["--all", "--multi-pod", "--no-measure", "--out",
                   str(out)])
    applicable = [(a, s) for a, s in _cells()
                  if RC.shape_applicable(RC.get_config(a), s)[0]]
    files = sorted(p.name for p in out.iterdir())
    assert files == sorted(f"{a}_{s}_2x16x16.json" for a, s in applicable)
    assert sum(r.get("skipped", False) for r in recs) == \
        len(list(_cells())) - len(applicable)
    rec = json.loads((out / "qwen3_1_7b_train_4k_2x16x16.json").read_text())
    assert rec["n_chips"] == 512 and rec["mesh"] == "2x16x16"
    assert all(rec[k] is None for k in D.ABSENT)
    assert set(rec["notes"]) >= {"hlo", "collectives", "memory", "timing",
                                 "flops_counted"}
    D.main(["--arch", "qwen3-1.7b", "--shape", "train_4k", "--multi-pod",
            "--skip-existing", "--out", str(out)])
    assert "[skip existing] qwen3_1_7b_train_4k_2x16x16" in \
        capsys.readouterr().out
    # one counted cell, and xLSTM's laid out without a count
    rec = D.run_cell("qwen3_1_7b", "decode_32k", save=False)
    assert rec["flops_counted"] > rec["model_flops"] * 0.5
    assert rec["flops_counted_per_device"] == rec["flops_counted"] / 256
    rec = D.run_cell("xlstm_350m", "train_4k", save=False)
    assert rec["flops_counted"] is None and "sLSTM" in \
        rec["notes"]["flops_counted"]
