"""0-1 knapsack for index-configuration selection (paper Section IV-B).

The tuner maximises the summed (forecasted) utility of the chosen
index set subject to the storage budget B.  Index storage footprints
are bytes; we discretise them into ``resolution`` buckets and run the
classic O(n * W) dynamic program.  For pathological instances where
the DP table would be too large we fall back to a utility-density
greedy (the standard 1/2-approximation companion); the benchmark's
instances (tens of candidate indexes) always take the exact path.

``solve`` returns a boolean keep-mask over the candidates.
"""
from __future__ import annotations

import numpy as np


def solve(utilities: np.ndarray, sizes: np.ndarray, budget: float,
          resolution: int = 512, force_keep: np.ndarray | None = None
          ) -> np.ndarray:
    """Exact (discretised) 0-1 knapsack.

    utilities : (n,) float  -- non-negative utility per index
    sizes     : (n,) float  -- storage footprint per index
    budget    : float       -- storage budget (same unit as sizes)
    force_keep: (n,) bool   -- indexes that must stay (e.g. indexes
                 needed by UPDATE processing in a write-intensive
                 phase; see the paper's footnote 1).  Their size is
                 pre-charged against the budget.
    """
    utilities = np.asarray(utilities, np.float64)
    sizes = np.asarray(sizes, np.float64)
    n = len(utilities)
    if n == 0:
        return np.zeros(0, bool)
    keep = np.zeros(n, bool)
    if force_keep is not None:
        keep |= np.asarray(force_keep, bool)
    budget = float(budget) - float(sizes[keep].sum())
    cand = np.nonzero(~keep)[0]
    # Infeasible forced set: keep the forced indexes anyway (the tuner
    # amortises the fix over later cycles) and take nothing else.
    if budget <= 0 or len(cand) == 0:
        return keep
    u = utilities[cand]
    s = sizes[cand]
    # Drop zero-utility candidates outright.
    useful = u > 0
    cand, u, s = cand[useful], u[useful], s[useful]
    if len(cand) == 0:
        return keep
    # Anything larger than the whole budget can never be chosen.
    fits = s <= budget
    cand, u, s = cand[fits], u[fits], s[fits]
    if len(cand) == 0:
        return keep

    W = int(resolution)
    scale = W / budget
    w = np.minimum(np.ceil(s * scale).astype(np.int64), W)
    w = np.maximum(w, 1)

    if len(cand) * W > 50_000_000:  # greedy fallback (never hit in bench)
        order = np.argsort(-(u / np.maximum(s, 1e-12)))
        rem = budget
        for i in order:
            if s[i] <= rem:
                keep[cand[i]] = True
                rem -= s[i]
        return keep

    # DP over discretised weights.
    dp = np.zeros(W + 1, np.float64)
    choice = np.zeros((len(cand), W + 1), bool)
    for i in range(len(cand)):
        wi, ui = w[i], u[i]
        cand_val = dp[: W + 1 - wi] + ui
        better = cand_val > dp[wi:]
        choice[i, wi:] = better
        dp[wi:] = np.where(better, cand_val, dp[wi:])
    # Backtrack.
    cap = W
    for i in range(len(cand) - 1, -1, -1):
        if choice[i, cap]:
            keep[cand[i]] = True
            cap -= w[i]
    return keep


def brute_force(utilities, sizes, budget):
    """Exponential oracle for property tests (n <= ~16)."""
    utilities = np.asarray(utilities, np.float64)
    sizes = np.asarray(sizes, np.float64)
    n = len(utilities)
    best_val, best_mask = -1.0, np.zeros(n, bool)
    for bits in range(1 << n):
        mask = np.array([(bits >> i) & 1 for i in range(n)], bool)
        if sizes[mask].sum() <= budget:
            v = utilities[mask].sum()
            if v > best_val:
                best_val, best_mask = v, mask
    return best_mask, best_val
