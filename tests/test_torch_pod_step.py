"""The port's pod train step (``make_train_step(compress_pod_grads=True,
mesh=...)``) held to the reference's own pieces, composed under
``jax.vmap(..., axis_name="pod")`` on the CPU.

The reference's ``compressed_step`` runs inside a partial-manual
``shard_map`` that this JAX cannot run on the CPU (its SPMD test is
``slow`` and may xfail), so the oracle is composed from the pieces it
calls, in its order: ``jax.value_and_grad(loss_fn)`` on each pod's
slice of the batch; ``compression.compressed_psum`` of every gradient
leaf and ``jax.lax.pmean`` of the loss over the 'pod' axis; then
``clip_by_global_norm``, the schedule and ``adamw_update``.

The int8 payload of an element moves by one step of its block's scale
when its input moves across a rounding boundary, so each stage is held
on the port's own inputs of that stage, over three steps: the pods'
losses and gradients from the port's masters (rtol = atol = 1e-4,
float32), the reduction from the port's per-pod gradients and
residuals (payloads equal, scales within one ulp, the reduced mean and
residuals within 1e-4), and clip + AdamW from the port's reduced
gradients (masters and moments within 1e-4).
"""

import _torch_threads  # noqa: F401  (first: pins torch's threads)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import model as RM
from repro.parallel import compression as RCP
from repro.train import optimizer as RO
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import train_state_to_numpy, tree_items
from repro_torch.parallel import compression
from repro_torch.parallel.mesh import force_local_devices, make_mesh
from repro_torch.train import optimizer as PO
from repro_torch.train import steps as PS

TOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")
LR = 1e-2   # constant: the warm-up's first step would move nothing


def _cfgs(arch):
    rcfg = RC.get_smoke_config(arch).scaled(dtype="float32")
    return rcfg, ModelConfig(**dataclasses.asdict(rcfg))


def _batch(rcfg, B, S, seed):
    rng = np.random.default_rng(seed)
    b = {"labels": rng.integers(1, rcfg.vocab_size, (B, S)).astype(np.int32)}
    if rcfg.input_kind == "embeds":
        b["embeds"] = rng.standard_normal((B, S, rcfg.d_model)).astype(
            np.float32)
    else:
        b["tokens"] = rng.integers(1, rcfg.vocab_size, (B, S)).astype(
            np.int32)
    if rcfg.family == "vlm":
        b["mrope_positions"] = np.stack([
            (np.arange(S, dtype=np.int32)[None, :] // k
             + np.arange(B, dtype=np.int32)[:, None]) for k in (1, 2, 4)])
    return b


def _pod_mesh(n_pods):
    with force_local_devices([CPU] * (4 * n_pods)):
        if n_pods == 2:
            return make_debug_mesh(2, 2, multi_pod=True)
        return make_mesh((n_pods, 2, 2), ("pod", "data", "model"))


def _np(t):
    return t.detach().cpu().numpy()


def _stack(leaf):
    return torch.stack([t.detach() for t in leaf]) if isinstance(leaf, list) \
        else leaf.detach()


def _ref_pod_batches(b, n):
    """The reference's batch with a leading pod axis: pod i's contiguous
    rows (axis 1 of the M-RoPE positions)."""
    out = {}
    for k, v in b.items():
        if k == "mrope_positions":
            out[k] = np.stack(np.split(v, n, axis=1))
        else:
            out[k] = np.stack(np.split(v, n, axis=0))
    return out


def _ref_grads_fn(rcfg):
    def one(params, b):
        return jax.value_and_grad(lambda p: RM.loss_fn(p, rcfg, b))(params)
    return jax.jit(jax.vmap(one, in_axes=(None, 0)))


def _podwise_reduce(g, e, loss):
    """One pod's side of the reduction: ``compressed_psum`` of every
    leaf and ``pmean`` of the loss over 'pod'."""
    flat_g, tdef = jax.tree.flatten(g)
    flat_e = jax.tree.flatten(e)[0]
    out_g, out_e = [], []
    for x, r in zip(flat_g, flat_e):
        rg, re = RCP.compressed_psum(x, "pod", r)
        out_g.append(rg.astype(x.dtype))
        out_e.append(re)
    return (tdef.unflatten(out_g), tdef.unflatten(out_e),
            jax.lax.pmean(loss, "pod"))


_ref_reduce = jax.jit(jax.vmap(_podwise_reduce, axis_name="pod"))


@jax.jit
def _ref_update(grads, opt, params, lr):
    grads, gnorm = RO.clip_by_global_norm(grads, 1.0)
    params, opt = RO.adamw_update(grads, opt, params, lr)
    return params, opt, gnorm


def _close(port_items, ref_tree, what, **tol):
    r_leaves = jax.tree.leaves(ref_tree)
    assert len(r_leaves) == len(port_items), what
    for (path, p), r in zip(port_items, r_leaves):
        np.testing.assert_allclose(_np(_stack(p)), np.asarray(r),
                                   err_msg=f"{what} {path}", **(tol or TOL))


@pytest.mark.parametrize("arch,n_pods", [("qwen3_1_7b", 2),
                                         ("qwen3_1_7b", 4),
                                         ("qwen2_vl_7b", 2)])
def test_pod_step_matches_reference_pieces_under_vmap(arch, n_pods,
                                                      monkeypatch):
    rcfg, pcfg = _cfgs(arch)
    mesh = _pod_mesh(n_pods)
    assert mesh.shape == {"pod": n_pods, "data": 2, "model": 2}
    state = PS.init_train_state(pcfg, torch.Generator().manual_seed(0),
                                error_feedback=n_pods, device="cpu")
    rec = {"grads": [], "quant": [], "reduced": None}
    real_vg, real_clip = PS.value_and_grad, PS.clip_by_global_norm
    real_q = compression.quantize_int8

    def vg(model, cfg, batch):
        loss, grads = real_vg(model, cfg, batch)
        rec["grads"].append((loss, grads))
        return loss, grads

    def clip(grads, max_norm):
        rec["reduced"] = {p: g.clone() for p, g in tree_items(grads)}
        return real_clip(grads, max_norm)

    def quant(x):
        q, s = real_q(x)
        rec["quant"].append((x.clone(), q, s))
        return q, s

    monkeypatch.setattr(PS, "value_and_grad", vg)
    monkeypatch.setattr(PS, "clip_by_global_norm", clip)
    monkeypatch.setattr(compression, "quantize_int8", quant)
    step = PS.make_train_step(pcfg, lambda s: torch.tensor(LR),
                              compress_pod_grads=True, mesh=mesh)
    ref_grads = _ref_grads_fn(rcfg)
    for s in range(3):
        b = _batch(rcfg, 8, 32, seed=s)
        before = train_state_to_numpy(state)
        ef_np = [{"/".join(p): _np(e) for p, e in tree_items(t)}
                 for t in state.ef]
        rec["grads"].clear()
        rec["quant"].clear()
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})

        # stage 1: each pod's loss and gradients from the port's masters
        rparams = jax.tree.map(jnp.asarray, before.params)
        rloss, rgrads = ref_grads(rparams, jax.tree.map(
            jnp.asarray, _ref_pod_batches(b, n_pods)))
        assert len(rec["grads"]) == n_pods
        for i, (loss, grads) in enumerate(rec["grads"]):
            np.testing.assert_allclose(float(loss), float(rloss[i]), **TOL)
            _close(tree_items(grads), jax.tree.map(lambda g: g[i], rgrads),
                   f"step {s} pod {i} grads")

        # stage 2: the reduction, from the port's per-pod gradients and
        # residuals; every payload on identical inputs
        for x, q, scale in rec["quant"]:
            rq, rs = RCP.quantize_int8(jnp.asarray(_np(x)))
            np.testing.assert_array_equal(_np(q), np.asarray(rq))
            np.testing.assert_array_max_ulp(_np(scale), np.asarray(rs),
                                            maxulp=1)
        assert len(rec["quant"]) == n_pods * len(tree_items(state.opt.mu))
        paths = [p for p, _ in tree_items(rec["grads"][0][1])]
        pod_g = {"/".join(p): np.stack([_np(dict(tree_items(g))[p])
                                        for _, g in rec["grads"]])
                 for p in paths}
        pod_e = {k: np.stack([e[k] for e in ef_np]) for k in pod_g}
        losses = np.array([float(loss) for loss, _ in rec["grads"]],
                          np.float32)
        red, new_e, rmean = _ref_reduce(pod_g, pod_e, losses)
        np.testing.assert_allclose(float(m["loss"]), float(rmean[0]),
                                   rtol=1e-6, atol=1e-6)
        for p in paths:
            key = "/".join(p)
            np.testing.assert_allclose(_np(rec["reduced"][p]),
                                       np.asarray(red[key][0]),
                                       err_msg=f"reduced {key}", **TOL)
            assert len(state.ef) == n_pods
            for i in range(n_pods):
                np.testing.assert_allclose(
                    _np(dict(tree_items(state.ef[i]))[p]),
                    np.asarray(new_e[key][i]), err_msg=f"residual {key}",
                    **TOL)

        # stage 3: clip + AdamW from the port's reduced gradients
        reduced = jax.tree.unflatten(
            jax.tree.structure(rparams),
            [jnp.asarray(_np(rec["reduced"][p])) for p in paths])
        rp, ropt, rgn = _ref_update(
            reduced, jax.tree.map(jnp.asarray, before.opt), rparams,
            jnp.float32(LR))
        np.testing.assert_allclose(float(m["grad_norm"]), float(rgn), **TOL)
        np.testing.assert_allclose(float(m["lr"]), LR, rtol=1e-7)
        _close(tree_items(state.params), rp, f"step {s} masters")
        _close(tree_items(state.opt.mu), ropt.mu, f"step {s} mu")
        _close(tree_items(state.opt.nu), ropt.nu, f"step {s} nu")
        assert int(state.opt.step) == s + 1
    # the serving copies are the updated masters (float32 compute)
    assert torch.equal(state.params.compute["embed"],
                       state.params.embed.detach())


def test_pod_step_needs_a_pod_axis_and_residuals():
    """No 'pod' axis (no mesh, or a mesh without one) fails when the step
    is made, as the reference's assertion does; a state without
    residuals fails before anything changes."""
    _, pcfg = _cfgs("qwen3_1_7b")
    lr = PO.cosine_schedule(1e-3, 2, 10)
    with force_local_devices([CPU] * 4):
        flat = make_debug_mesh(2, 2)
    for mesh in (None, flat):
        with pytest.raises(AssertionError, match="'pod' mesh axis"):
            PS.make_train_step(pcfg, lr, compress_pod_grads=True, mesh=mesh)
    step = PS.make_train_step(pcfg, lr, compress_pod_grads=True,
                              mesh=_pod_mesh(2))
    b = _batch(RC.get_smoke_config("qwen3_1_7b"), 8, 16, 0)
    for ef in (0, 1, 3):   # none, or not one tree per pod
        state = PS.init_train_state(pcfg, torch.Generator().manual_seed(0),
                                    error_feedback=ef, device="cpu")
        before = train_state_to_numpy(state)
        with pytest.raises(ValueError, match="error_feedback=2"):
            step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        for x, y in zip(jax.tree.leaves(train_state_to_numpy(state)),
                        jax.tree.leaves(before)):
            np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="does not split over 2 pods"):
        PS.pod_batch({"tokens": torch.zeros((3, 4))}, 0, 2)


def test_pod_batch_slices_rows_and_mrope_axis_1():
    tok = torch.arange(8 * 3).reshape(8, 3)
    mrope = torch.arange(3 * 8 * 3).reshape(3, 8, 3)
    got = [PS.pod_batch({"tokens": tok, "mrope_positions": mrope}, i, 4)
           for i in range(4)]
    assert torch.equal(torch.cat([g["tokens"] for g in got]), tok)
    assert torch.equal(torch.cat([g["mrope_positions"] for g in got], 1),
                       mrope)
    assert got[1]["tokens"].shape == (2, 3)
