"""The port's dry-run stand-ins (``repro_torch.launch.specs``) held to
the reference's ``jax.eval_shape`` / ``ShapeDtypeStruct`` stand-ins on
the CPU: for every config and every applicable shape, the batch, the
decode cache, the parameters and the train state (float32 and 8-bit
moments) leaf for leaf in shape and dtype, all on ``meta``; and the
batch and cache placements against the reference's on an
``AbstractMesh`` of both production shapes.
"""

import _torch_threads  # noqa: F401  (first: pins torch's threads)

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.configs as RC
from repro.launch import specs as R_specs
from repro.parallel import sharding as R_sh
from repro_torch.launch import specs as P_specs
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import sharding as sh

META = torch.device("meta")
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _pcfg(rcfg):
    return ModelConfig(**dataclasses.asdict(rcfg))


def _dtype(t):
    return str(t.dtype).replace("torch.", "")


def _same(port: dict, ref: dict, what):
    assert sorted(port) == sorted(ref), what
    for k, v in port.items():
        assert v.device == META, (what, k)
        assert tuple(v.shape) == tuple(ref[k].shape), (what, k)
        assert _dtype(v) == str(np.dtype(ref[k].dtype)), (what, k)


def _cells():
    for arch in RC.ARCH_IDS:
        for shape in RC.SHAPES:
            if RC.shape_applicable(RC.get_config(arch), shape)[0]:
                yield arch, shape


@pytest.mark.parametrize("arch,shape", list(_cells()))
def test_input_and_decode_specs_match_eval_shape(arch, shape):
    """``input_specs`` (and for decode cells ``decode_specs``' tokens,
    cache and position) against the reference's, with and without the
    serving variant's repeated, head-padded cache under a 16-way model
    axis; and their placements on both production meshes."""
    rcfg = RC.get_config(arch)
    kind = RC.SHAPES[shape][2]
    variants = [rcfg]
    if kind == "decode":
        variants.append(rcfg.scaled(param_dtype="bfloat16",
                                    pad_attn_heads=True,
                                    cache_repeated_kv=rcfg.q_rep <= 2))
    for name, shape_of in MESHES.items():
        amesh = AbstractMesh(tuple(shape_of.values()), tuple(shape_of))
        for cfg in variants:
            with R_sh.activate(amesh):
                ref = R_specs.input_specs(cfg, shape)
            with sh.activate(amesh):
                got = P_specs.input_specs(_pcfg(cfg), shape)
            if kind != "decode":
                _same(got, ref, f"{arch} {shape}")
                rsh = R_specs.batch_shardings(amesh, ref)
                psh = P_specs.batch_shardings(amesh, got)
                assert {k: tuple(v.spec) for k, v in rsh.items()} == \
                    {k: v.spec for k, v in psh.items()}
                continue
            _same({k: got[k] for k in ("tokens", "pos")},
                  {k: ref[k] for k in ("tokens", "pos")}, f"{arch} {shape}")
            _same(got["cache"], ref["cache"], f"{arch} {shape} cache")
            tok = {"tokens": got["tokens"]}
            assert P_specs.batch_shardings(amesh, tok)["tokens"].spec == \
                tuple(R_specs.batch_shardings(
                    amesh, {"tokens": ref["tokens"]})["tokens"].spec)
            rc = R_specs.cache_shardings(amesh, cfg, ref["cache"])
            pc = P_specs.cache_shardings(amesh, _pcfg(cfg), got["cache"])
            assert {k: tuple(v.spec) for k, v in rc.items()} == \
                {k: v.spec for k, v in pc.items()}, (arch, shape, name)


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_abstract_params_and_train_state_match_eval_shape(arch):
    """Every leaf of ``abstract_params`` and ``abstract_train_state``
    (float32 and 8-bit moments, the step count; the ``--opt`` variant's
    bf16 masters) equals the reference's ``eval_shape`` leaf in path,
    shape and dtype; nothing is allocated."""
    rcfg = RC.get_config(arch)
    for cfg in (rcfg, rcfg.scaled(param_dtype="bfloat16")):
        for bits8 in (False, True):
            ref = R_specs.abstract_train_state(cfg, bits8=bits8)
            got = P_specs.abstract_train_state(_pcfg(cfg), bits8=bits8)
            r_leaves = jax.tree_util.tree_flatten_with_path(ref)[0]
            p_leaves = list(sh.leaves_with_paths(got))
            assert ["/".join(p) for p, _ in p_leaves] == \
                [R_sh._path_str(p) for p, _ in r_leaves]
            for (path, x), (_, r) in zip(p_leaves, r_leaves):
                t = x[0] if isinstance(x, list) else x
                assert t.device == META, path
                assert sh.leaf_shape(x) == tuple(r.shape), path
                assert _dtype(t) == str(np.dtype(r.dtype)), path
        ref_p = R_specs.abstract_params(cfg)
        got_p = P_specs.abstract_params(_pcfg(cfg))
        assert [sh.leaf_shape(x) for _, x in sh.leaves_with_paths(got_p)] \
            == [tuple(r.shape) for r in jax.tree.leaves(ref_p)]
    assert P_specs.sds((2, 3), torch.int32).device == META
