"""CART decision-tree workload classifier (paper Section IV-A).

Classifies workload snapshots as READ_INTENSIVE or WRITE_INTENSIVE
from three domain-specific features collected by the workload monitor
(deliberately independent of system utilisation, as the paper argues):

  f0  ratio of scan queries to mutators
  f1  ratio of tuples accessed via indexes (vs. direct table access)
  f2  average number of tuples scanned per query

The tree is trained with the classic CART algorithm (Gini impurity,
binary splits, greedy best-gain, depth-limited + pruned by minimum
samples per leaf).  Training snapshots come from synthetic OLTP/OLAP
workload mixtures generated by ``bench_db`` (mirroring the
paper's use of OLTP-Bench traces).  Prediction is a jit-friendly
array-encoded tree walk so the tuner can classify inside fused cycles.

The classifier abstains (returns UNKNOWN) when a snapshot holds fewer
than ``min_samples`` queries -- the paper's guard for periods of low
system utilisation.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np

WRITE_INTENSIVE = 0
READ_INTENSIVE = 1
UNKNOWN = -1

N_FEATURES = 3


class TreeArrays(NamedTuple):
    """Array-encoded binary tree.  node i: if feature[i] < 0 it is a
    leaf with label ``label[i]``; else test features[feature[i]] <=
    threshold[i] and go to left[i] / right[i]."""

    feature: np.ndarray    # (n_nodes,) int32
    threshold: np.ndarray  # (n_nodes,) float32
    left: np.ndarray       # (n_nodes,) int32
    right: np.ndarray      # (n_nodes,) int32
    label: np.ndarray      # (n_nodes,) int32


def _gini(y: np.ndarray) -> float:
    if len(y) == 0:
        return 0.0
    p = np.bincount(y, minlength=2) / len(y)
    return float(1.0 - np.sum(p * p))


@dataclass
class CartClassifier:
    """CART trainer + predictor."""

    max_depth: int = 4
    min_leaf: int = 4
    min_samples: int = 8  # abstention threshold on snapshot size
    tree: TreeArrays | None = None
    feature_names: tuple = ("scan_mutator_ratio", "index_access_ratio",
                            "avg_tuples_scanned")
    _nodes: list = field(default_factory=list)

    # ---- training -----------------------------------------------------
    def fit(self, X: np.ndarray, y: np.ndarray) -> "CartClassifier":
        X = np.asarray(X, np.float32)
        y = np.asarray(y, np.int32)
        assert X.ndim == 2 and X.shape[1] == N_FEATURES
        self._nodes = []
        self._grow(X, y, depth=0)
        n = len(self._nodes)
        self.tree = TreeArrays(
            feature=np.array([nd[0] for nd in self._nodes], np.int32),
            threshold=np.array([nd[1] for nd in self._nodes], np.float32),
            left=np.array([nd[2] for nd in self._nodes], np.int32),
            right=np.array([nd[3] for nd in self._nodes], np.int32),
            label=np.array([nd[4] for nd in self._nodes], np.int32),
        )
        assert n >= 1
        return self

    def _grow(self, X, y, depth) -> int:
        node_id = len(self._nodes)
        self._nodes.append(None)  # reserve
        majority = int(np.argmax(np.bincount(y, minlength=2)))
        if depth >= self.max_depth or len(y) < 2 * self.min_leaf or _gini(y) == 0.0:
            self._nodes[node_id] = (-1, 0.0, -1, -1, majority)
            return node_id
        best = None  # (gain, feat, thr)
        parent = _gini(y)
        for f in range(X.shape[1]):
            order = np.argsort(X[:, f], kind="stable")
            xs, ys = X[order, f], y[order]
            # candidate thresholds at midpoints between distinct values
            distinct = np.nonzero(np.diff(xs) > 1e-12)[0]
            for i in distinct:
                nl = i + 1
                nr = len(ys) - nl
                if nl < self.min_leaf or nr < self.min_leaf:
                    continue
                g = parent - (nl * _gini(ys[:nl]) + nr * _gini(ys[nl:])) / len(ys)
                thr = 0.5 * (xs[i] + xs[i + 1])
                if best is None or g > best[0]:
                    best = (g, f, thr)
        if best is None or best[0] <= 1e-9:
            self._nodes[node_id] = (-1, 0.0, -1, -1, majority)
            return node_id
        _, f, thr = best
        mask = X[:, f] <= thr
        lid = self._grow(X[mask], y[mask], depth + 1)
        rid = self._grow(X[~mask], y[~mask], depth + 1)
        self._nodes[node_id] = (f, float(thr), lid, rid, majority)
        return node_id

    # ---- prediction ---------------------------------------------------
    def predict(self, x: np.ndarray, n_samples: int | None = None) -> int:
        """Classify one feature vector; abstain on thin snapshots."""
        if n_samples is not None and n_samples < self.min_samples:
            return UNKNOWN
        assert self.tree is not None, "classifier not fitted"
        t = self.tree
        i = 0
        while t.feature[i] >= 0:
            i = int(t.left[i] if x[t.feature[i]] <= t.threshold[i] else t.right[i])
        return int(t.label[i])

    def predict_batch(self, X: np.ndarray) -> np.ndarray:
        return np.array([self.predict(x) for x in np.asarray(X, np.float32)],
                        np.int32)

    def describe(self) -> str:
        """Human-readable rules (the interpretability argument of IV-A)."""
        assert self.tree is not None
        lines = []

        def rec(i, indent):
            t = self.tree
            pad = "  " * indent
            if t.feature[i] < 0:
                lab = {0: "WRITE_INTENSIVE", 1: "READ_INTENSIVE"}[int(t.label[i])]
                lines.append(f"{pad}-> {lab}")
                return
            name = self.feature_names[int(t.feature[i])]
            lines.append(f"{pad}if {name} <= {float(t.threshold[i]):.4g}:")
            rec(int(t.left[i]), indent + 1)
            lines.append(f"{pad}else:")
            rec(int(t.right[i]), indent + 1)

        rec(0, 0)
        return "\n".join(lines)


def default_training_set(n: int = 512, seed: int = 0):
    """Synthetic labelled snapshots mirroring the paper's OLTP/OLAP
    training traces: OLTP-ish snapshots have low scan/mutator ratios,
    high index-access ratios and small scans; OLAP-ish snapshots are
    the opposite.  Noise keeps the split non-trivial."""
    rng = np.random.default_rng(seed)
    half = n // 2
    # write-intensive (label 0).  The ratio of scans to mutators is the
    # cleanest discriminator (as in the paper's pruned tree, Fig. 4);
    # the volume features carry workload-dependent noise.
    w = np.stack([
        rng.uniform(0.0, 0.9, half),          # scan/mutator ratio: low
        rng.uniform(0.4, 1.0, half),          # index access ratio: high
        rng.lognormal(4.0, 2.5, half),        # tuples scanned: noisy-small
    ], axis=1)
    # read-intensive (label 1)
    r = np.stack([
        rng.uniform(1.1, 50.0, half),
        rng.uniform(0.0, 0.7, half),
        rng.lognormal(7.0, 2.5, half),
    ], axis=1)
    X = np.concatenate([w, r]).astype(np.float32)
    y = np.concatenate([np.zeros(half, np.int32), np.ones(half, np.int32)])
    perm = rng.permutation(n)
    return X[perm], y[perm]


def default_classifier() -> CartClassifier:
    X, y = default_training_set()
    return CartClassifier().fit(X, y)
