"""The statement stream of a traffic mix, drawn from the run's seed.

A frozen copy of the TUNER templates (paper Section V-A: LOW-S, MOD-S,
LOW-U, HIGH-U) and of the phased scan / update mixtures of Section V-B,
as the repository's TUNER generator writes them: quantile-anchored
range bounds, a fixed projection list, three attributes set to uniform
values per update.  It reads only the parameters of a traffic file
(``pibench/workloads/<name>.json``):

``table``               the table the statements address
``segment_statements``  statements per ``run_workload`` call
``read_batch_size``     consecutive scans per read burst
``phase_statements``    statements per phase; phases take their
                        predicate attributes in turn from a seeded
                        permutation of the attributes
``phase_attrs``         1 (LOW-S phases) or 2 (MOD-S pairs)
``scan_share``          share of scans; the rest are writes
``scan_template``       "LOW-S" or "MOD-S"
``scan_selectivity``    share of rows a scan's bounds span (joint for
                        MOD-S: each attribute spans its square root)
``projectivity``        share of attributes in the projection list
``writes``              {"LOW-U" | "HIGH-U": weight}
``write_selectivity``   share of rows an update's bounds span
``write_set_attrs``     attributes an update sets

The stream is a pure function of (parameters, seed, statement index):
segment ``k`` draws from its own generator, phase ``p``'s attributes
from theirs, so every run with one seed sends the same statements, in
the same order, however many segments its window takes.  Phase
attributes follow a permutation rather than independent draws, so no
seed's window repeats an attribute in consecutive phases, which would
leave its index useful across the shift and make that seed's work
lighter than another's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

DOMAIN = 1_000_000

# Stream keys of the generators derived from one seed.
_PROJ, _PHASE, _SEGMENT = 1, 2, 3


@dataclass(frozen=True)
class Stmt:
    """One statement, in the harness's own terms."""

    kind: str  # "scan" | "update"
    template: str
    attrs: Tuple[int, ...]
    los: Tuple[int, ...]
    his: Tuple[int, ...]
    agg_attr: int = 0
    proj_attrs: Tuple[int, ...] = ()
    set_attrs: Tuple[int, ...] = ()
    set_vals: Tuple[int, ...] = ()


class Traffic:
    def __init__(self, params: Dict, n_attrs: int, quantiles: np.ndarray,
                 seed: int, stream: int = 0):
        self.p = params
        self.n_attrs = int(n_attrs)
        self.q = quantiles
        self.seed = int(seed)
        self.stream = int(stream)  # 0: the window; others: warm-up
        self.seg_len = int(params["segment_statements"])
        self.phase_len = int(params["phase_statements"])
        self.k = int(params["phase_attrs"])
        self.writes = sorted(params.get("writes", {}).items())
        p = self.n_attrs - 1
        rng = self._rng(_PROJ)
        k = max(1, int(round(float(params["projectivity"]) * p)))
        self.proj = tuple(sorted(
            int(a) for a in rng.choice(np.arange(1, p + 1), size=k,
                                       replace=False)))
        self._order = [int(a) for a in self._rng(_PHASE).permutation(
            np.arange(1, p + 1))]

    def _rng(self, *key: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, self.stream, *key])

    def phase_attrs(self, phase: int) -> Tuple[int, ...]:
        """Phase ``phase``'s predicate attributes: the next ``k`` of a
        seeded permutation of a_1..a_p, taken in turn, so consecutive
        phases never share an attribute and every seed shifts alike."""
        p = self.n_attrs - 1
        i = phase * self.k
        return tuple(self._order[(i + j) % p] for j in range(self.k))

    # -- bounds (the TUNER generator's quantile anchoring) ---------------
    def _bounds(self, rng, sel: float):
        pos = float(rng.uniform(0.0, max(1.0 - sel, 1e-6)))
        n = len(self.q)
        i0 = int(pos * (n - 1))
        i1 = min(int((pos + sel) * (n - 1)), n - 1)
        lo, hi = int(self.q[i0]), int(self.q[i1])
        return (hi, lo) if lo > hi else (lo, hi)

    def _set(self, rng):
        p = self.n_attrs - 1
        n_set = int(self.p["write_set_attrs"])
        attrs = tuple(int(a) for a in rng.choice(np.arange(1, p + 1),
                                                 size=n_set, replace=False))
        vals = tuple(int(v) for v in rng.integers(1, DOMAIN, size=n_set))
        return attrs, vals

    # -- templates ----------------------------------------------------------
    def _scan(self, rng, attrs) -> Stmt:
        sel = float(self.p["scan_selectivity"])
        if self.p["scan_template"] == "LOW-S":
            lo, hi = self._bounds(rng, sel)
            return Stmt("scan", "LOW-S", attrs[:1], (lo,), (hi,),
                        agg_attr=min(2, self.n_attrs - 1),
                        proj_attrs=self.proj)
        s_each = float(np.sqrt(sel))
        lo0, hi0 = self._bounds(rng, s_each)
        lo1, hi1 = self._bounds(rng, s_each)
        return Stmt("scan", "MOD-S", attrs[:2], (lo0, lo1), (hi0, hi1),
                    agg_attr=min(3, self.n_attrs - 1), proj_attrs=self.proj)

    def _write(self, rng, template, attrs, phase) -> Stmt:
        sel = float(self.p["write_selectivity"])
        if template == "LOW-U":
            lo, hi = self._bounds(rng, sel)
            sa, sv = self._set(rng)
            return Stmt("update", "LOW-U", attrs[:1], (lo,), (hi,),
                        set_attrs=sa, set_vals=sv)
        if len(attrs) >= 2:
            pair = attrs[:2]
        else:  # the phase's attribute and the next phase's
            a, b = attrs[0], self.phase_attrs(phase + 1)[0]
            pair = (a, b if b != a else (a % (self.n_attrs - 1)) + 1)
        s_each = float(np.sqrt(sel))
        lo0, hi0 = self._bounds(rng, s_each)
        lo1, hi1 = self._bounds(rng, s_each)
        sa, sv = self._set(rng)
        return Stmt("update", "HIGH-U", pair, (lo0, lo1), (hi0, hi1),
                    set_attrs=sa, set_vals=sv)

    def segment(self, index: int) -> List[Tuple[int, Stmt]]:
        """Segment ``index``'s statements as (phase, Stmt)."""
        rng = self._rng(_SEGMENT, index)
        scan_share = float(self.p["scan_share"])
        names = [t for t, _ in self.writes]
        weights = np.array([w for _, w in self.writes], float)
        out = []
        for i in range(index * self.seg_len, (index + 1) * self.seg_len):
            phase = i // self.phase_len
            attrs = self.phase_attrs(phase)
            if not names or rng.uniform() < scan_share:
                out.append((phase, self._scan(rng, attrs)))
            else:
                t = names[int(rng.choice(len(names), p=weights
                                         / weights.sum()))]
                out.append((phase, self._write(rng, t, attrs, phase)))
        return out

    def max_new_rows(self, stmts, update_cap: int) -> int:
        """Most row versions ``stmts`` can append (each update at most
        ``update_cap``)."""
        return sum(update_cap for _, s in stmts if s.kind == "update")
