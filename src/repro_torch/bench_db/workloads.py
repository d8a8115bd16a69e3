"""TUNER workload generators (paper Section V-B).

A workload is a list of (phase_id, Query).  Phases hold one query type
(with varying parameters); mixtures dial the scan/update ratio; the
affinity knob controls how many distinct predicate sub-domains the
queries target (Figure 8); shifting workloads rotate the predicate
attribute set between phases (Figure 10).

Port of ``repro.bench_db.workloads``: the same numpy RNG calls in the
same order on the port's ``QueryGen``, so one seed yields the
reference's query sequence.  ``affinity_workload`` with the
``high_s`` template emits HIGH-S joins, which the executor runs one by
one (``Database._exec_join``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from repro_torch.bench_db.queries import QueryGen
from repro_torch.core.executor import Query

MIXTURES = {
    "read_only": 1.00,
    "read_heavy": 0.90,
    "balanced": 0.50,
    "write_heavy": 0.10,
}


@dataclass
class Workload:
    items: List[Tuple[int, Query]]
    description: str = ""

    def __iter__(self):
        return iter(self.items)

    def __len__(self):
        return len(self.items)

    @property
    def n_phases(self) -> int:
        return 1 + max((p for p, _ in self.items), default=0)


def affinity_workload(gen: QueryGen, total: int = 1000, phase_len: int = 500,
                      n_subdomains: int = 5, template: str = "mod_s",
                      noise_frac: float = 0.0, seed: int = 3) -> Workload:
    """Queries targeting ``n_subdomains`` fixed quantile anchors --
    higher affinity = fewer sub-domains (Figure 8: 2 / 5 / 10).
    ``noise_frac`` mixes in one-off queries on random other attributes
    (the Figure 6 noise guard)."""
    rng = np.random.default_rng(seed)
    anchors = list(rng.uniform(0.0, 0.9, size=n_subdomains))
    items: List[Tuple[int, Query]] = []
    n_attrs = gen.db.tables[gen.table].n_attrs
    for i in range(total):
        phase = i // phase_len
        pos = float(anchors[int(rng.integers(n_subdomains))])
        if noise_frac > 0 and rng.uniform() < noise_frac:
            a = int(rng.integers(5, n_attrs - 1))
            q = gen.low_s(attr=a)
        elif template == "mod_s":
            q = gen.mod_s(pos=pos)
        elif template == "low_s":
            q = gen.low_s(pos=pos)
        elif template == "high_s":
            q = gen.high_s(pos=pos)
        else:
            raise ValueError(template)
        items.append((phase, q))
    return Workload(items, f"affinity({n_subdomains} subdomains, "
                           f"{template}, phase={phase_len})")


def shifting_workload(gen: QueryGen, total: int = 1000, phase_len: int = 100,
                      complexity: str = "low", seed: int = 5) -> Workload:
    """Each phase queries a different attribute pair -- the tuner must
    detect the shift and re-index (Figure 10)."""
    rng = np.random.default_rng(seed)
    items: List[Tuple[int, Query]] = []
    n_attrs = gen.db.tables[gen.table].n_attrs
    n_phases = (total + phase_len - 1) // phase_len
    phase_attrs = [tuple(int(a) for a in
                         rng.choice(np.arange(1, n_attrs), 2, replace=False))
                   for _ in range(n_phases)]
    for i in range(total):
        phase = i // phase_len
        attrs = phase_attrs[phase]
        if complexity == "low":
            q = gen.low_s(attr=attrs[0])
        else:
            q = gen.mod_s(attrs=attrs)
        items.append((phase, q))
    return Workload(items, f"shifting(phase={phase_len}, {complexity})")


def hybrid_workload(gen: QueryGen, mixture: str, total: int = 1000,
                    phase_len: int = 100, seed: int = 9) -> Workload:
    """Scan/update mixtures of Section V-B (LOW-S scans + LOW-U/HIGH-U
    updates at the given ratio), phased like the shifting workload."""
    scan_frac = MIXTURES[mixture]
    rng = np.random.default_rng(seed)
    items: List[Tuple[int, Query]] = []
    n_attrs = gen.db.tables[gen.table].n_attrs
    n_phases = (total + phase_len - 1) // phase_len
    phase_attr = [int(a) for a in
                  rng.choice(np.arange(1, n_attrs), n_phases)]
    for i in range(total):
        phase = i // phase_len
        a = phase_attr[phase]
        if rng.uniform() < scan_frac:
            q = gen.low_s(attr=a)
        elif rng.uniform() < 0.5:
            q = gen.low_u(attr=a)
        else:
            b = phase_attr[(phase + 1) % n_phases]
            q = gen.high_u(attrs=(a, b if b != a else (a % (n_attrs - 1)) + 1))
        items.append((phase, q))
    return Workload(items, f"hybrid({mixture}, phase={phase_len})")


def segments_workload(gen: QueryGen, seg_len: int = 500, seed: int = 13
                      ) -> Workload:
    """Figure 7's three segments: two scan segments based on *multiple
    query templates* (different attribute pairs and selectivities, as
    in the paper), then an insert segment."""
    rng = np.random.default_rng(seed)
    items: List[Tuple[int, Query]] = []
    seg_templates = [[(1, 2), (2, 6), (7, 8)],
                     [(3, 5), (5, 9), (10, 11)]]
    base_sel = gen.selectivity
    for seg, templates in enumerate(seg_templates):
        for i in range(seg_len):
            attrs = templates[int(rng.integers(len(templates)))]
            gen.selectivity = base_sel * float(rng.uniform(0.5, 4.0))
            items.append((seg, gen.mod_s(attrs=attrs,
                                         pos=float(rng.uniform(0, 0.9)))))
    gen.selectivity = base_sel
    for i in range(seg_len):
        items.append((2, gen.ins(n=16)))
    return Workload(items, "segments(scan,scan,insert)")
