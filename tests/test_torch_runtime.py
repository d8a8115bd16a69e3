"""Parity of the port's training runtime with the reference's, on the
CPU: the token pipeline (``repro_torch.data``), checkpoints and the
fault-tolerant loop (``repro_torch.runtime``), gradient compression
(``repro_torch.parallel.compression``) and the train launcher
(``repro_torch.launch.train``); tests/test_runtime.py's cases on the
port; and a JAX-free import of every training module.

Tolerances: the pipeline, checkpoints, restore-and-replay and int8
payloads are held bit for bit; compression's scales within one ulp, its
reduced mean rtol 1e-6 / atol 1e-7 (the scales' sum runs in another
order) and its residuals within two ulps of the largest dequantised
value (XLA fuses the product into the subtraction); a step after a
restored checkpoint rtol / atol 1e-4 (float32); the launcher's bf16
losses against the reference's within 2e-3 (the measured gap over the
first 10 smoke steps is at most 2.3e-4).
"""

import _torch_threads  # noqa: F401  (first: pins torch's threads)

import dataclasses
import os
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.data import TokenPipeline as RPipe
from repro.launch import train as R_train
from repro.parallel import compression as RC8
from repro.runtime import CheckpointManager as RCkpt
from repro.train import optimizer as RO
from repro.train import steps as RS
from repro_torch.data import TokenPipeline
from repro_torch.launch import train as P_train
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import (train_state_from_reference,
                                        train_state_to_numpy)
from repro_torch.parallel import compression
from repro_torch.runtime import CheckpointManager, FaultTolerantLoop, Heartbeat
from repro_torch.runtime.fault_tolerance import PrefetchWithBackup
from repro_torch.train import optimizer as PO
from repro_torch.train import steps as PS

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs(arch, **over):
    rcfg = RC.get_smoke_config(arch).scaled(**{"dtype": "float32", **over})
    return rcfg, ModelConfig(**dataclasses.asdict(rcfg))


def _port(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _leaves_equal(port_np, ref_np):
    a, b = jax.tree.leaves(port_np), jax.tree.leaves(ref_np)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# ---------------------------------------------------------------------------
# Data pipeline
# ---------------------------------------------------------------------------

def test_pipeline_matches_reference():
    for seed, step, hosts in ((0, 0, 1), (3, 5, 4), (7, 123, 2)):
        for host in range(hosts):
            args = dict(vocab_size=1000, seq_len=16, global_batch=8,
                        seed=seed, n_hosts=hosts, host_id=host)
            got = TokenPipeline(**args).host_batch_at(step)
            want = RPipe(**args).host_batch_at(step)
            assert got.keys() == want.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
    it, rit = iter(TokenPipeline(512, 64, 8)), iter(RPipe(512, 64, 8))
    for _ in range(3):
        np.testing.assert_array_equal(next(it)["tokens"], next(rit)["tokens"])


def test_pipeline_determinism_and_host_sharding():
    p = TokenPipeline(1000, 16, 8, seed=3)
    a, b = p.batch_at(5), p.batch_at(5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    hosts = [TokenPipeline(1000, 16, 8, seed=3, n_hosts=4, host_id=i)
             for i in range(4)]
    parts = [h.host_batch_at(5)["tokens"] for h in hosts]
    np.testing.assert_array_equal(np.concatenate(parts), a["tokens"])


# ---------------------------------------------------------------------------
# Checkpointing
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.int32)}}
    ckpt.save(10, tree)
    like = {"a": torch.zeros(3, 4),
            "b": {"c": torch.zeros(5, dtype=torch.int32)}}
    out = ckpt.restore(like)
    assert torch.equal(out["a"], tree["a"])
    assert torch.equal(out["b"]["c"], tree["b"]["c"])
    assert out["b"]["c"].dtype == torch.int32


def test_checkpoint_retention_and_latest(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=2)
    tree = {"x": torch.zeros(3)}
    for s in (1, 2, 3, 4):
        ckpt.save(s, tree)
    assert ckpt.latest_step() == 4
    kept = sorted(p.name for p in tmp_path.iterdir())
    assert kept == ["step_00000003", "step_00000004"]


def test_checkpoint_shape_mismatch_raises(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(0, {"x": torch.zeros((3,))})
    with pytest.raises(ValueError):
        ckpt.restore({"x": torch.zeros((4,))})


def test_checkpoint_host_sharded_commit(tmp_path):
    """Two hosts write the leaves they own (index modulo 2); the first
    commit leaves a ``.tmp``, the second renames it, and a restore reads
    both hosts' leaves."""
    tree = {"a": torch.arange(4.0), "b": torch.arange(3), "c": torch.ones(2)}
    h0 = CheckpointManager(str(tmp_path), n_processes=2, process_id=0)
    h1 = CheckpointManager(str(tmp_path), n_processes=2, process_id=1)
    assert h0.save(5, tree).name == "step_00000005.tmp"
    assert h0.latest_step() is None
    assert sorted(p.name for p in (tmp_path / "step_00000005.tmp").iterdir()
                  ) == ["arr_00000.npy", "arr_00002.npy", "commit_0",
                        "manifest.json"]
    assert h1.save(5, tree).name == "step_00000005"
    names = sorted(p.name for p in (tmp_path / "step_00000005").iterdir())
    assert names == ["arr_00000.npy", "arr_00001.npy", "arr_00002.npy",
                     "commit_0", "commit_1", "manifest.json"]
    out = h0.restore({k: torch.zeros_like(v) for k, v in tree.items()})
    for k in tree:
        assert torch.equal(out[k], tree[k])


@pytest.mark.parametrize("bits8", [False, True])
def test_reference_checkpoint_restores_into_the_port(bits8, tmp_path):
    """The reference trains qwen3-1.7b's smoke config (float32) for three
    steps and saves its state; the port restores it into a fresh state
    of its own (leaf for leaf, bit for bit), saves it in the same layout
    (the reference restores it, bit for bit), and with float32 moments
    takes the fourth step, equal to the reference's fourth."""
    rcfg, pcfg = _cfgs("qwen3_1_7b")
    pipe = RPipe(rcfg.vocab_size, 32, 2, seed=4)
    step = jax.jit(RS.make_train_step(rcfg, RO.cosine_schedule(3e-3, 1, 10),
                                      bits8=bits8))
    rstate = RS.init_train_state(rcfg, jax.random.PRNGKey(0), bits8=bits8)
    for s in range(3):
        rstate, _ = step(rstate, {k: jnp.asarray(v)
                                  for k, v in pipe.batch_at(s).items()})
    RCkpt(str(tmp_path / "ref")).save(2, rstate)
    like = PS.init_train_state(pcfg, torch.Generator().manual_seed(1),
                               bits8=bits8, device="cpu")
    got_step, state = CheckpointManager(str(tmp_path / "ref")).restore_step(
        like)
    assert got_step == 2 and int(state.opt.step) == 3
    _leaves_equal(train_state_to_numpy(state), jax.tree.map(np.asarray,
                                                            rstate))
    CheckpointManager(str(tmp_path / "port")).save(2, state)
    back = RCkpt(str(tmp_path / "port")).restore(rstate)
    _leaves_equal(back, jax.tree.map(np.asarray, rstate))
    if bits8:
        return
    rstate, rm = step(rstate, {k: jnp.asarray(v)
                               for k, v in pipe.batch_at(3).items()})
    pstep = PS.make_train_step(pcfg, PO.cosine_schedule(3e-3, 1, 10))
    state, pm = pstep(state, _port(pipe.batch_at(3)))
    for k in rm:
        np.testing.assert_allclose(float(pm[k]), float(rm[k]), **TOL)
    port_np = train_state_to_numpy(state)
    for a, b in zip(jax.tree.leaves(port_np), jax.tree.leaves(rstate)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)


# ---------------------------------------------------------------------------
# The fault-tolerant loop, backup batches, heartbeat
# ---------------------------------------------------------------------------

def test_fault_tolerant_loop_recovers(tmp_path):
    """A step that fails once mid-run resumes from the last checkpoint
    and converges to the same final state as a failure-free run."""
    def step(state, batch):
        return state + batch, {"v": state}

    def batches():
        for i in range(100):
            yield torch.tensor(float(i))

    loop_a = FaultTolerantLoop(step, CheckpointManager(str(tmp_path / "a"),
                                                       keep=3), save_every=5)
    ref, _, rec_a = loop_a.run(torch.tensor(0.0), batches(), 20)
    assert rec_a == 0
    boom = {"armed": True}

    def injector(s):
        if s == 13 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("simulated node failure")

    loop_b = FaultTolerantLoop(step, CheckpointManager(str(tmp_path / "b"),
                                                       keep=3), save_every=5)
    out, _, rec_b = loop_b.run(torch.tensor(0.0), batches(), 20,
                               fault_injector=injector)
    assert rec_b == 1
    assert float(out) == float(ref)


def test_train_loop_replays_bit_for_bit_after_a_fault(tmp_path):
    """The train step in the loop on granite-moe-1b-a400m's smoke config
    (bf16), a fault injected after the first checkpoint: the final
    masters and moments equal the run without the fault, bit for bit,
    with one recovery (``batch_buf[step % save_every]`` replays the
    batches since that checkpoint)."""
    _, pcfg = _cfgs("granite_moe_1b_a400m", dtype="bfloat16")
    pipe = TokenPipeline(pcfg.vocab_size, 32, 4, seed=2)
    step = PS.make_train_step(pcfg, PO.cosine_schedule(3e-3, 2, 8))
    runs = []
    for name, fail_at in (("a", None), ("b", 5)):
        armed = {"on": fail_at is not None}

        def injector(s):
            if armed["on"] and s == fail_at:
                armed["on"] = False
                raise RuntimeError("simulated node failure")

        state = PS.init_train_state(pcfg, torch.Generator().manual_seed(0),
                                    device="cpu")
        loop = FaultTolerantLoop(step, CheckpointManager(
            str(tmp_path / name), keep=2), save_every=3)
        batches = (_port(b) for b in pipe)
        state, hist, rec = loop.run(state, batches, 8,
                                    fault_injector=injector)
        runs.append((train_state_to_numpy(state), rec, len(hist)))
    (a, rec_a, n_a), (b, rec_b, n_b) = runs
    assert (rec_a, rec_b) == (0, 1) and n_b == n_a + 2
    _leaves_equal(b, a)


def test_prefetch_backup_serves_stale_on_deadline():
    def slow():
        yield 1
        time.sleep(0.3)
        yield 2

    src = PrefetchWithBackup(slow(), deadline_s=0.05)
    got = [next(src), next(src)]
    assert got == [1, 1]          # stale backup served
    assert src.stale_served >= 1


def test_heartbeat_beats_until_stopped(tmp_path):
    path = tmp_path / "beat"
    hb = Heartbeat(str(path), interval_s=0.02).start()
    time.sleep(0.2)
    hb.stop()
    n = len(path.read_text().splitlines())
    assert n >= 2
    time.sleep(0.1)
    assert len(path.read_text().splitlines()) == n


# ---------------------------------------------------------------------------
# Gradient compression
# ---------------------------------------------------------------------------

def test_compression_roundtrip_and_error_feedback():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(512,)).astype(np.float32))
    q, s = compression.quantize_int8(x)
    y = compression.dequantize_int8(q, s, x.shape)
    assert float(torch.linalg.norm(y - x) / torch.linalg.norm(x)) < 0.02
    rq, rs = RC8.quantize_int8(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_max_ulp(s.numpy(), np.asarray(rs), maxulp=1)
    np.testing.assert_array_equal(y.numpy(), np.asarray(
        RC8.dequantize_int8(jnp.asarray(q.numpy()), jnp.asarray(s.numpy()),
                            x.shape)))
    # error feedback keeps the long-run mean unbiased
    err = torch.zeros_like(x)
    total_sent = torch.zeros(512)
    for _ in range(50):
        corrected = x + err
        q, s = compression.quantize_int8(corrected)
        sent = compression.dequantize_int8(q, s, x.shape)
        err = corrected - sent
        total_sent += sent
    step = float(x.abs().max()) / 127.0
    np.testing.assert_allclose((total_sent / 50).numpy(), x.numpy(),
                               atol=step / 2 + 1e-6)
    assert compression.compression_ratio((10,)) == RC8.compression_ratio(
        (10,))


_PSUM_SCRIPT = textwrap.dedent("""
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.parallel.compression import compressed_psum
    n, out = int(sys.argv[1]), sys.argv[2]
    assert jax.device_count() == n
    rng = np.random.default_rng(n)
    xs = rng.standard_normal((n, 3, 300)).astype(np.float32)
    es = (rng.standard_normal((n, 3, 300)) * 1e-2).astype(np.float32)
    mesh = jax.make_mesh((n,), ("pod",))

    def pod(x, e):
        r, ne = compressed_psum(x[0], "pod", e[0])
        return r[None], ne[None]

    f = jax.jit(jax.shard_map(pod, mesh=mesh, in_specs=(P("pod"), P("pod")),
                              out_specs=(P("pod"), P("pod")),
                              check_vma=False))
    r, ne = f(xs, es)
    np.savez(out, xs=xs, es=es, reduced=np.asarray(r), errors=np.asarray(ne))
""")


@pytest.mark.parametrize("n", [2, 4])
def test_compressed_psum_matches_reference_shard_map(n, tmp_path):
    """The port's one-controller ``compressed_psum`` over the list of
    pods' contributions against the reference's under ``shard_map`` on
    ``n`` forced host devices (a subprocess): every pod's reduced mean
    and new residual."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS=f"--xla_force_host_platform_device_count={n}")
    out = tmp_path / "psum.npz"
    proc = subprocess.run([sys.executable, "-c", _PSUM_SCRIPT, str(n),
                           str(out)], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = np.load(out)
    xs = [torch.from_numpy(x) for x in ref["xs"]]
    es = [torch.from_numpy(e) for e in ref["es"]]
    reduced, errors = compression.compressed_psum(xs, es)
    for i in range(n):
        np.testing.assert_allclose(reduced.numpy(), ref["reduced"][i],
                                   rtol=1e-6, atol=1e-7)
        # jitted, XLA rounds ``corrected - q * scale`` once (a fused
        # multiply-subtract): within two ulps of the largest product
        ulp = np.spacing(np.abs(ref["xs"][i] + ref["es"][i]).max())
        np.testing.assert_allclose(errors[i].numpy(), ref["errors"][i],
                                   rtol=0, atol=2 * ulp)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def test_launcher_matches_reference(monkeypatch, tmp_path):
    """``repro_torch.launch.train.main([... "--smoke", "--device",
    "cpu"])`` against the reference's launcher over 10 steps of
    qwen3-1.7b's smoke config (bf16 compute, the launcher's cosine
    schedule, batches and loop), the port started from the reference's
    initial state: every loss within 2e-3 of the reference's (measured:
    at most 2.3e-4), and both falling."""
    argv = ["--arch", "qwen3-1.7b", "--smoke", "--steps", "10",
            "--save-every", "5", "--log-every", "5"]
    ref = R_train.main(argv + ["--ckpt", str(tmp_path / "ref")])
    rcfg = RC.get_smoke_config("qwen3-1.7b")
    ref_init = jax.tree.map(np.asarray, RS.init_train_state(
        rcfg, jax.random.PRNGKey(0)))

    def init(cfg, generator, bits8=False, error_feedback=False, device=None):
        return train_state_from_reference(cfg, ref_init, device)

    monkeypatch.setattr(P_train, "init_train_state", init)
    got = P_train.main(argv + ["--ckpt", str(tmp_path / "port"),
                               "--device", "cpu"])
    assert len(got) == len(ref) == 10
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-3)
    assert got[-1] < got[0] and ref[-1] < ref[0]
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == [
        "step_00000004", "step_00000009"]


def test_launcher_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        P_train.main(["--smoke", "--steps", "1", "--ckpt", str(tmp_path)])


def test_launcher_trains_every_config(tmp_path):
    """Two steps of every smoke config through the launcher (the VLM and
    audio backbones on tokens), each loss finite."""
    for arch in RC.ARCH_IDS:
        losses = P_train.main(["--arch", arch, "--smoke", "--steps", "2",
                               "--batch", "2", "--seq", "32", "--device",
                               "cpu", "--ckpt", str(tmp_path / arch)])
        assert len(losses) == 2 and np.isfinite(losses).all(), arch


def test_training_modules_import_no_jax_and_no_reference():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch.train, repro_torch.train.optimizer, "
        "repro_torch.train.steps, repro_torch.data, repro_torch.runtime, "
        "repro_torch.runtime.fault_tolerance, "
        "repro_torch.parallel.compression, repro_torch.launch.train, "
        "repro_torch.models.convert, chip_smoke\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None "
        "and (m == 'repro' or m.startswith(('repro.', 'jax')))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
