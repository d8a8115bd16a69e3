"""The port's sharding rules, meshes and elastic re-sharding
(``repro_torch.parallel.sharding``, ``repro_torch.launch.mesh``,
``repro_torch.runtime.elastic``) held to the reference on the CPU.

Host logic is held bit for bit on the reference tests' ``FakeMesh``
(an object with a ``shape``): the four unit cases of
``tests/test_sharding.py``, and every leaf's spec of every config's
parameters and train states (float32 and 8-bit moments), at smoke and
published shapes, on five mesh shapes.  The reference's mesh-active
runs (its 8-device SPMD test, ``jax.jit`` under a sharded mesh) fail
under this JAX, so placement is held by its own invariant: a state
split over a forced device list gathers back bit for bit.  Head padding
under a tensor-parallel axis is held to the reference's cache shapes
and to the port's unpadded attention.  The one-device-per-shard scan
fan-out ports ``test_sharded_engine.py::
test_pmap_fanout_multi_device_subprocess``.
"""

import _torch_threads  # noqa: F401  (first: pins torch's threads)

import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as RP

import repro.configs as RC
from repro.launch import mesh as R_mesh
from repro.models import model as RM
from repro.parallel import sharding as R_sh
from repro.runtime import elastic as R_el
from repro.train import optimizer as RO
from repro.train import steps as RS
from repro.core import engine as R_eng
from repro_torch.core import engine as P_eng
from repro_torch.launch import mesh as P_lmesh
from repro_torch.launch import specs as P_specs
from repro_torch.models import layers as PL
from repro_torch.models import model as PM
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import mesh as P_mesh
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.sharding import P
from repro_torch.runtime import CheckpointManager
from repro_torch.runtime import elastic
from repro_torch.train import steps as PS
from test_torch_mesh import SRC, _bounds, _state
from test_torch_sharded import _assert_result_equal

CPU = torch.device("cpu")
META = torch.device("meta")


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.size = 1
        for v in shape.values():
            self.size *= v


MESH_SHAPES = {
    "4x4": {"data": 4, "model": 4},
    "2x4": {"data": 2, "model": 4},
    "2x2x2": {"pod": 2, "data": 2, "model": 2},
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
}


def _pcfg(rcfg):
    return ModelConfig(**dataclasses.asdict(rcfg))


# ---------------------------------------------------------------------------
# The four unit cases of tests/test_sharding.py
# ---------------------------------------------------------------------------

def test_spec_rules_divisibility():
    mesh = FakeMesh({"data": 4, "model": 4})
    with sh.activate(mesh):
        # divisible: head-sharded qkv + fsdp
        assert sh.spec_for_path("layers/attn/wq", (2, 64, 64)) == \
            P(None, "data", "model")
        # vocab-sharded embedding
        assert sh.spec_for_path("embed", (1024, 64)) == P("model", "data")
        # non-divisible dims are dropped per-dimension
        assert sh.spec_for_path("layers/attn/wq", (2, 63, 64)) == \
            P(None, None, "model")
        # norms replicated
        assert sh.spec_for_path("layers/norm1", (2, 64)) == P()


def test_spec_rules_moe_ep_vs_tp_conflict():
    mesh = FakeMesh({"data": 2, "model": 4})
    with sh.activate(mesh):
        # E=8 divisible by model=4 -> ep wins, tp suppressed (same axis)
        spec = sh.spec_for_path("layers/moe/w_gate", (2, 8, 64, 128))
        assert spec == P(None, "model", "data", None)
        # E=6 not divisible -> ep dropped, tp on ff
        spec = sh.spec_for_path("layers/moe/w_gate", (2, 6, 64, 128))
        assert spec == P(None, None, "data", "model")


def test_quant8_moment_paths():
    mesh = FakeMesh({"data": 2, "model": 4})
    with sh.activate(mesh):
        assert sh.spec_for_path("opt/mu/layers/mlp/w_gate/q",
                                (2, 64, 128)) == P(None, "data", "model")
        assert sh.spec_for_path("opt/mu/layers/mlp/w_gate/scale",
                                (64,)) == P()
        # the positional aliases of a Quant8 pair, as in the reference
        for path, shape in (("opt/mu/layers/mlp/w_gate/0", (2, 64, 128)),
                            ("opt/nu/embed/1", (64,)),
                            ("opt/nu/layers/attn/bq/q", (2, 64)),
                            ("opt/nu/layers/attn/q_norm/q", (2, 64))):
            with R_sh.activate(mesh):
                want = tuple(R_sh.spec_for_path(path, shape))
            assert sh.spec_for_path(path, shape) == want, path


def test_no_active_mesh_is_noop():
    x = torch.ones((4, 4))
    assert sh.constrain(x, ("dp", "tp")) is x
    assert sh.axis_size("tp") == 1
    assert sh.logical_spec((4, 4), ("dp", "tp")) == P()
    with sh.activate(FakeMesh({"data": 2, "model": 4})):
        assert sh.constrain(x, ("dp", "tp")) is x   # one controller
        assert sh.axis_size("tp") == 4 and sh.axis_size("dp") == 2
    assert sh.axis_size("tp") == 1


def test_spec_type_follows_partition_spec():
    """Equality, normalisation and repr as ``jax.sharding.
    PartitionSpec``'s."""
    for entries in ((), (None,), ("data",), (("data",), None),
                    (("pod", "data"), None, "model"), (None, None)):
        r = RP(*entries)
        p = P(*entries)
        assert p == tuple(r) and repr(p) == repr(r), entries
    assert P() != P(None, None) and RP() != RP(None, None)
    assert P(None, ("pod", "data")).mesh_axes(1) == ("pod", "data")
    assert P("model").mesh_axes(0) == ("model",)
    assert P("model").mesh_axes(3) == ()


# ---------------------------------------------------------------------------
# Every leaf's spec, every config
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_abstract_state(arch, smoke, bits8):
    rcfg = (RC.get_smoke_config if smoke else RC.get_config)(arch)
    params = jax.eval_shape(
        lambda: RM.init_params(rcfg, jax.random.PRNGKey(0)))
    opt = jax.eval_shape(lambda p: RO.adamw_init(p, bits8=bits8), params)
    return rcfg, RS.TrainState(params, opt, None)


def _ref_specs(tree, mesh):
    with R_sh.activate(mesh):
        return [tuple(R_sh.spec_for_path(R_sh._path_str(p), leaf.shape))
                for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "published"])
@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_every_leaf_spec_matches_reference(arch, smoke):
    """``spec_for_path`` / ``param_specs`` / ``tree_shardings`` of the
    port's parameters and train states (float32 and 8-bit moments; at
    published shapes on ``meta``) against the reference's on its
    ``eval_shape`` pytrees, leaf for leaf in the reference's order, on
    the five mesh shapes; the reference's ``tree_shardings`` runs on an
    ``AbstractMesh`` of the same shape."""
    for bits8 in (False, True):
        rcfg, rstate = _ref_abstract_state(arch, smoke, bits8)
        state = P_specs.abstract_train_state(_pcfg(rcfg), bits8=bits8)
        r_paths = [R_sh._path_str(p) for p, _ in
                   jax.tree_util.tree_flatten_with_path(rstate)[0]]
        leaves = list(sh.leaves_with_paths(state))
        assert ["/".join(p) for p, _ in leaves] == r_paths
        assert [sh.leaf_shape(x) for _, x in leaves] == [
            tuple(x.shape) for x in jax.tree.leaves(rstate)]
        for name, shape in MESH_SHAPES.items():
            fake = FakeMesh(shape)
            want = _ref_specs(rstate, fake)
            with sh.activate(fake):
                got = [sh.spec_for_path(sh._path_str(p), sh.leaf_shape(x))
                       for p, x in leaves]
                placed = [x for _, x in sh.leaves_with_paths(
                    sh.tree_shardings(fake, state))]
                pspecs = [x for _, x in sh.leaves_with_paths(
                    sh.param_specs(state.params))]
            assert got == want, (arch, name, bits8)
            assert [x.spec for x in placed] == want
            assert all(x.mesh is fake for x in placed)
            n_params = len(pspecs)
            assert pspecs == want[:n_params]
            if not bits8 and not smoke:
                amesh = AbstractMesh(tuple(shape.values()), tuple(shape))
                with R_sh.activate(amesh):
                    rsh = R_sh.tree_shardings(amesh, rstate.params)
                assert [tuple(x.spec) for x in jax.tree.leaves(rsh)] == \
                    want[:n_params], (arch, name)


def test_mesh_options_and_batch_axes_for_1_to_512_devices():
    """``degraded_mesh_options`` and ``batch_spec_axes`` against the
    reference's for every device count up to 512, on meshes the port
    builds over forced lists of that many entries."""
    for n in range(1, 513):
        opts = elastic.degraded_mesh_options(n)
        assert opts == R_el.degraded_mesh_options(n), n
        with P_mesh.force_local_devices([META] * n):
            for data, model in opts[:2]:
                m = P_lmesh.make_debug_mesh(data, model)
                assert m.shape == {"data": data, "model": model}
                assert m.size == n
                assert P_lmesh.batch_spec_axes(m) == \
                    R_mesh.batch_spec_axes(FakeMesh(m.shape)) == ("data",)
            if n % 2 == 0 and opts:
                data, model = elastic.degraded_mesh_options(n // 2)[0]
                m = P_lmesh.make_debug_mesh(data, model, multi_pod=True)
                assert m.shape == {"pod": 2, "data": data, "model": model}
                assert P_lmesh.batch_spec_axes(m) == \
                    R_mesh.batch_spec_axes(FakeMesh(m.shape)) == \
                    ("pod", "data")


def test_production_and_debug_meshes():
    """As ``jax.make_mesh``: row-major over the local devices, raising
    with fewer devices than the shape needs."""
    with pytest.raises(ValueError, match="needs 256 devices; 1 are"):
        with P_mesh.force_local_devices([CPU]):
            P_lmesh.make_production_mesh()
    with P_mesh.force_local_devices([META] * 512):
        single = P_lmesh.make_production_mesh()
        multi = P_lmesh.make_production_mesh(multi_pod=True)
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.axis_names == ("pod", "data", "model")
    devs = [torch.device("cpu", i) for i in range(8)]
    with P_mesh.force_local_devices(devs):
        m = P_lmesh.make_debug_mesh(2, 2, multi_pod=True)
        m2 = P_lmesh.make_debug_mesh(4, 2)
    assert m.flat_devices == tuple(devs)
    assert m.devices[1][0][1] == devs[5]   # pod 1, data 0, model 1
    assert m2.devices[3][1] == devs[7]
    with pytest.raises(AttributeError):
        m.shape = {}
    m.shape["pod"] = 5          # a copy: the mesh is unchanged
    assert m.shape["pod"] == 2


# ---------------------------------------------------------------------------
# Elastic re-sharding
# ---------------------------------------------------------------------------

def _smoke_state(arch="qwen3_1_7b", bits8=False, error_feedback=False):
    pcfg = _pcfg(RC.get_smoke_config(arch).scaled(dtype="float32"))
    return pcfg, PS.init_train_state(pcfg, torch.Generator().manual_seed(1),
                                     bits8=bits8,
                                     error_feedback=error_feedback,
                                     device="cpu")


def _whole(leaf):
    return torch.stack([t.detach() for t in leaf]) if isinstance(leaf, list) \
        else leaf.detach()


def _debug_mesh(n, devices):
    with P_mesh.force_local_devices(devices):
        if n == 2:
            return P_lmesh.make_debug_mesh(1, 2)
        if n == 4:
            return P_lmesh.make_debug_mesh(2, 2)
        return P_lmesh.make_debug_mesh(2, 2, multi_pod=True)


@pytest.mark.parametrize("bits8", [False, True])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_reshard_then_gather_is_bit_equal(n, bits8):
    """Every leaf of a train state (masters, moments, residuals) split
    over n forced CPU entries: each entry's slice is the leaf's
    contiguous block at its mesh coordinates, entries that name one
    device share a slice they both hold, and the gather gives every
    leaf back bit for bit in the reference's layout."""
    for arch in ("qwen3_1_7b", "granite_moe_1b_a400m", "xlstm_350m"):
        _reshard_round_trip(n, *_smoke_state(arch, bits8, True))


def _reshard_round_trip(n, pcfg, state):
    mesh = _debug_mesh(n, [CPU] * n)
    resharded = elastic.reshard_state(mesh, state)
    with sh.activate(mesh):
        specs = [sh.spec_for_path(sh._path_str(p), sh.leaf_shape(x))
                 for p, x in sh.leaves_with_paths(state)]
    got = list(sh.leaves_with_paths(resharded))
    src = list(sh.leaves_with_paths(state))
    assert [p for p, _ in got] == [p for p, _ in src]
    split = 0
    for (path, t), (_, x), spec in zip(got, src, specs):
        assert isinstance(t, elastic.ShardedTensor) and t.spec == spec
        whole = _whole(x)
        assert t.shape == tuple(whole.shape) and len(t.shards) == n
        parts = 1
        for c in t.split_counts:
            parts *= c
        split += parts > 1
        # one tensor per distinct slice on the one device
        assert len({id(s) for s in t.shards}) == parts, path
        for coords, piece in zip(np.ndindex(*mesh.shape.values()), t.shards):
            key = t._slices(coords)
            assert torch.equal(piece, whole[key]), path
            assert piece.is_contiguous()
            assert piece.data_ptr() != whole.data_ptr()
    assert split > 0
    gathered = elastic.gather_state(resharded)
    out = list(sh.leaves_with_paths(gathered))
    assert len(out) == len(src)
    for (path, g), (_, x) in zip(out, src):
        w = _whole(x)
        assert g.dtype == w.dtype and torch.equal(g, w), path


def test_reshard_places_each_entry_on_its_device():
    """Entries that name distinct devices each hold their own slice there
    (a leaf the spec leaves whole is one tensor per device), and the
    gather lands on a named device."""
    pcfg, state = _smoke_state()
    with P_mesh.force_local_devices([CPU, META] * 2):
        mesh = P_lmesh.make_debug_mesh(2, 2)
    r = elastic.reshard_state(mesh, state.params)
    norm = r["final_norm"]
    assert norm.spec == P() and len({id(t) for t in norm.shards}) == 2
    assert [t.device for t in norm.shards] == [CPU, META] * 2
    wq = r["layers"]["attn"]["wq"]
    assert wq.spec == P(None, "data", "model") and wq.split_counts == (1, 2, 2)
    assert len({id(t) for t in wq.shards}) == 4
    assert wq.nbytes() == 4 * wq.shards[0].numel() * 4
    whole = _whole([b.attn.wq for b in state.params.blocks])
    assert torch.equal(wq.shards[0], whole[:, :whole.shape[1] // 2,
                                          :whole.shape[2] // 2])
    with pytest.raises(NotImplementedError):
        wq.gather("cpu")   # a meta slice holds no data


def test_elastic_restore_onto_another_mesh(tmp_path):
    """The reference's elastic leg: masters saved from one mesh's state,
    restored, resharded onto a 4 x 2 mesh and gathered equal the saved
    masters bit for bit."""
    pcfg, state = _smoke_state()
    mesh = _debug_mesh(8, [CPU] * 8)
    with sh.activate(mesh):
        placed = elastic.reshard_state(mesh, state)
    ck = CheckpointManager(str(tmp_path))
    ck.save(0, state.params)
    restored = ck.restore(state.params)
    with P_mesh.force_local_devices([CPU] * 8):
        mesh2 = P_lmesh.make_debug_mesh(4, 2, multi_pod=False)
    with sh.activate(mesh2):
        resharded = elastic.reshard_state(mesh2, restored)
    assert resharded["embed"].spec == P("model", "data")
    gathered = elastic.gather_state(resharded)
    want = elastic.gather_state(placed.params)
    for (p, a), (_, b) in zip(sh.leaves_with_paths(gathered),
                              sh.leaves_with_paths(want)):
        assert torch.equal(a, b), p


# ---------------------------------------------------------------------------
# Attention heads under a tensor-parallel axis
# ---------------------------------------------------------------------------

def _ref_cache_shapes(rcfg, mesh, B, S):
    with R_sh.activate(mesh):
        tree = jax.eval_shape(lambda: RM.init_cache(rcfg, B, S))
    return {k: (tuple(v.shape), str(v.dtype)) for k, v in tree.items()}


def _port_cache_shapes(pcfg, mesh, B, S, device):
    with sh.activate(mesh):
        tree = PM.init_cache(pcfg, B, S, device=device)
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tree.items()}


def test_head_padding_smoke_config_under_model_axis_8():
    """qwen3's smoke config (4 heads) with ``pad_attn_heads`` and
    ``cache_repeated_kv`` under a model axis of 8: the cache holds 8
    heads as the reference's does, and the padded heads change neither
    the attention nor prefill / decode output."""
    rcfg = RC.get_smoke_config("qwen3_1_7b").scaled(
        dtype="float32", pad_attn_heads=True, cache_repeated_kv=True)
    pcfg = _pcfg(rcfg)
    mesh = FakeMesh({"data": 1, "model": 8})
    assert _port_cache_shapes(pcfg, mesh, 2, 16, CPU) == \
        _ref_cache_shapes(rcfg, mesh, 2, 16)
    with sh.activate(mesh):
        assert PM.cache_heads(pcfg) == 8
    with R_sh.activate(mesh):
        assert RM.cache_heads(rcfg) == 8
    assert PM.cache_heads(pcfg) == pcfg.n_heads == 4
    model = PM.init_params(pcfg, torch.Generator().manual_seed(2), "cpu")
    blk = model.blocks[0]
    x = torch.randn((2, 16, pcfg.d_model), generator=torch.Generator()
                    .manual_seed(3))
    pos = torch.arange(16, dtype=torch.int32)[None].expand(2, 16)
    with torch.no_grad():
        plain = PL.attention(x, blk.attn.p, pcfg, pos)
        with sh.activate(mesh):
            q, k, v = PL._qkv(x, blk.attn.p, pcfg, pos)
            k, v = PL._repeat_kv(k, v, pcfg)
            qp, kp, vp, H = PL._maybe_pad_heads(q, k, v, pcfg)
            padded = PL.attention(x, blk.attn.p, pcfg, pos)
    assert qp.shape[2] == 8 and H == 4
    assert torch.equal(qp[:, :, 4:], torch.zeros_like(qp[:, :, 4:]))
    torch.testing.assert_close(padded, plain, rtol=1e-6, atol=1e-6)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        1, pcfg.vocab_size, (2, 9)).astype(np.int32))
    outs = {}
    for name, m in (("plain", None), ("mesh", mesh)):
        with torch.no_grad(), sh.activate(m):
            cache = PM.init_cache(pcfg, 2, 16, device="cpu")
            logits = []
            for t in range(9):
                lg, cache = PM.decode_step(model, pcfg, toks[:, t:t + 1],
                                           cache, t)
                logits.append(lg)
        outs[name] = (torch.stack(logits), cache["k"].shape[3])
    assert outs["plain"][1] == 4 and outs["mesh"][1] == 8
    torch.testing.assert_close(outs["mesh"][0], outs["plain"][0],
                               rtol=1e-5, atol=1e-5)


def test_head_padding_published_qwen2_7b_under_model_axis_16():
    """qwen2-7b's 28 heads pad to 32 on a 16-way model axis: the cache
    (``cache_repeated_kv``) equals the reference's ``init_cache`` under
    the same mesh, on ``meta``; qwen3-1.7b's 16 heads pad nothing."""
    mesh = FakeMesh({"data": 16, "model": 16})
    for arch, heads in (("qwen2_7b", 32), ("qwen3_1_7b", 16)):
        rcfg = RC.get_config(arch).scaled(pad_attn_heads=True,
                                          cache_repeated_kv=True)
        pcfg = _pcfg(rcfg)
        got = _port_cache_shapes(pcfg, mesh, 4, 64, META)
        assert got == _ref_cache_shapes(rcfg, mesh, 4, 64)
        assert got["k"][0][3] == heads
        with sh.activate(mesh):
            q = torch.empty((4, 8, pcfg.n_heads, pcfg.hd), device=META)
            qp, _, _, H = PL._maybe_pad_heads(q, q, q, pcfg)
        assert qp.shape[2] == heads and H == pcfg.n_heads


# ---------------------------------------------------------------------------
# The storage engine's one-device-per-shard fan-out
# ---------------------------------------------------------------------------

def test_pmap_fanout_over_four_forced_devices():
    """With 4 forced CPU entries ``shard_fanout_devices`` gives the
    one-device-per-shard list and ``pmap_batched_full_table_scan`` (the
    plain path per shard, as in the reference's ``pmap`` form) equals
    the reference's stacked dispatch and the port's stacked fan-out bit
    for bit, and the single-shard engine's sums and counts."""
    rst, _, _, pst, _, _, _ = _state("uniform")
    assert P_eng.shards_uniform(pst) and R_eng.shards_uniform(rst)
    los, his, tss = _bounds(6, seed=5)
    ref = R_eng.ScanEngine().scan_batch(
        rst, "table", None, (1,), (1,), jnp.asarray(los), jnp.asarray(his),
        jnp.asarray(tss), 2)
    one = R_eng.ScanEngine().scan_batch(
        SRC.tables["narrow"], "table", None, (1,), (1,), jnp.asarray(los),
        jnp.asarray(his), jnp.asarray(tss), 2)
    args = (torch.from_numpy(los), torch.from_numpy(his),
            torch.from_numpy(tss), 2)
    stacked = P_eng.sharded_batched_scan(pst, "table", None, (1,), (1,),
                                         *args)
    assert sh.shard_fanout_devices(1) is None
    assert sh.shard_fanout_devices(4) is None   # no card here
    with P_mesh.force_local_devices([CPU] * 4):
        assert sh.shard_fanout_devices(4) == (CPU,) * 4
        assert sh.shard_fanout_devices(8) is None
        got = P_eng.pmap_batched_full_table_scan(pst, (1,), *args)
        _assert_result_equal(ref, got, "pmap")
        _assert_result_equal(stacked, got, "stacked")
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(one[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(one[1]))
    with pytest.raises(ValueError, match="one device per shard"):
        P_eng.pmap_batched_full_table_scan(pst, (1,), *args)
    assert "pmap" in P_eng.ScanEngine.TIERS


def test_distribution_modules_import_no_jax_and_no_reference():
    """The five modules import neither JAX nor the reference package."""
    root = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch.parallel.sharding, repro_torch.runtime.elastic, "
        "repro_torch.launch.mesh, repro_torch.launch.specs, "
        "repro_torch.launch.dryrun\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None "
        "and (m == 'repro' or m.startswith(('repro.', 'jax')))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
