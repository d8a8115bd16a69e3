"""Sharded checkpointing with atomic commits and retention: the port of
``repro.runtime.checkpoint``, with its directory layout::

    <root>/step_00000500.tmp/        (written)
    <root>/step_00000500/            (atomic rename on success)
        manifest.json                (structure, shapes, dtypes)
        arr_00000.npy ...            (one file per leaf)
        commit_<process>             (one marker per writing host)

* **Atomicity** -- writers fill a ``.tmp`` directory and rename; a
  crash mid-write never corrupts the latest checkpoint, and restore
  picks the newest complete directory.
* **Host-sharded writes** -- each host writes only the leaves it owns
  (leaf index modulo process count); the last to commit renames.
* **Retention** -- the newest ``keep`` complete checkpoints stay.

Leaves are numbered in the order of ``jax.tree.flatten`` on the
reference's state: dict keys sorted, tuple (and ``NamedTuple``) fields
in order, ``None`` no leaf, a ``Quant8`` its (q, scale), and an
``LM``'s masters as the reference's parameter leaves, each layer slot
stacked on a leading axis (``models.convert.param_leaves``).  So a
checkpoint the reference writes restores into the port's state, and
the reverse.  Arrays are stored unsharded, as host numpy arrays.
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import time
from typing import Any, Callable, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.models.convert import (nest, param_leaves,
                                        params_from_reference)
from repro_torch.models.model import LM

_STEP_RE = re.compile(r"step_(\d+)$")


class _Stacked:
    """A layer leaf of an ``LM``: its layers' tensors, one array when
    stored."""

    def __init__(self, layers):
        self.layers = layers
        self.shape = (len(layers),) + tuple(layers[0].shape)
        self.dtype = layers[0].dtype

    def host(self) -> np.ndarray:
        out = np.empty(self.shape, _host_dtype(self.dtype))
        for i, t in enumerate(self.layers):
            out[i] = t.detach().cpu().numpy()
        return out


def _host_dtype(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, _Stacked):
        return leaf.host()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree, out: List) -> Callable[[Iterator], Any]:
    """Append ``tree``'s leaves to ``out`` in the reference's order;
    return the function that rebuilds a tree of its structure from an
    iterator over host arrays: a tensor leaf on its device in its
    dtype, an ``LM`` as a new model on its device."""
    if tree is None:
        return lambda it: None
    if isinstance(tree, LM):
        items = param_leaves(tree)
        out.extend(_Stacked(leaf) if isinstance(leaf, list) else leaf
                   for _, leaf in items)
        paths = [path for path, _ in items]
        cfg, device = tree.cfg, tree.embed.device
        return lambda it: params_from_reference(
            cfg, nest((path, next(it)) for path in paths), device)
    if isinstance(tree, dict):
        keys = sorted(tree)
        fns = [_flatten(tree[k], out) for k in keys]
        return lambda it: {k: f(it) for k, f in zip(keys, fns)}
    if isinstance(tree, (tuple, list)):
        fns = [_flatten(x, out) for x in tree]
        if hasattr(tree, "_fields"):                       # NamedTuple
            return lambda it: type(tree)(*[f(it) for f in fns])
        return lambda it: type(tree)(f(it) for f in fns)
    out.append(tree)
    if isinstance(tree, torch.Tensor):
        return lambda it: torch.from_numpy(next(it)).to(
            device=tree.device, dtype=tree.dtype)
    return lambda it: next(it)


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3, n_processes: int = 1,
                 process_id: int = 0):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.n_processes = max(n_processes, 1)
        self.process_id = process_id

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any) -> pathlib.Path:
        tmp = self.root / f"step_{step:08d}.tmp"
        final = self.root / f"step_{step:08d}"
        if final.exists():
            return final
        tmp.mkdir(parents=True, exist_ok=True)
        leaves: List = []
        _flatten(tree, leaves)
        manifest = {
            "step": step,
            "n_leaves": len(leaves),
            "treedef": type(tree).__name__,
            "n_processes": self.n_processes,
            "leaves": [{"shape": list(np.shape(x)),
                        "dtype": _host_dtype(x.dtype if hasattr(x, "dtype")
                                             else np.asarray(x).dtype)}
                       for x in leaves],
            "time": time.time(),
        }
        for i, leaf in enumerate(leaves):
            if i % self.n_processes != self.process_id:
                continue  # owned by another host
            np.save(tmp / f"arr_{i:05d}.npy", _host(leaf))
        (tmp / f"commit_{self.process_id}").write_text("ok")
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        # last committer renames
        commits = list(tmp.glob("commit_*"))
        if len(commits) == self.n_processes:
            os.replace(tmp, final)
            self._gc()
            return final
        return tmp

    # ------------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = []
        for p in self.root.iterdir():
            m = _STEP_RE.search(p.name)
            if m and not p.name.endswith(".tmp") and \
                    (p / "manifest.json").exists():
                steps.append(int(m.group(1)))
        return max(steps) if steps else None

    def restore(self, like: Any, step: Optional[int] = None) -> Any:
        """Restore into the structure of ``like`` (shapes validated):
        each tensor on the device and in the dtype of ``like``'s."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        d = self.root / f"step_{step:08d}"
        leaves: List = []
        rebuild = _flatten(like, leaves)
        arrays = []
        for i, leaf in enumerate(leaves):
            arr = np.load(d / f"arr_{i:05d}.npy")
            want = tuple(np.shape(leaf))
            if tuple(arr.shape) != want:
                raise ValueError(
                    f"leaf {i}: checkpoint shape {arr.shape} != {want}")
            arrays.append(arr)
        return rebuild(iter(arrays))

    def restore_step(self, like: Any, step: Optional[int] = None):
        step = self.latest_step() if step is None else step
        return step, self.restore(like, step)

    # ------------------------------------------------------------------
    def _gc(self) -> None:
        steps = sorted(
            int(_STEP_RE.search(p.name).group(1))
            for p in self.root.iterdir()
            if _STEP_RE.search(p.name) and not p.name.endswith(".tmp"))
        for s in steps[: max(len(steps) - self.keep, 0)]:
            shutil.rmtree(self.root / f"step_{s:08d}", ignore_errors=True)
