"""Predictive prefix-cache management -- the paper's technique applied
to LLM serving.

Port of ``repro.serving.prefix_cache`` over the port's Holt-Winters
forecaster (``core.forecaster``, bit-equal to the reference's) and
knapsack.  The per-prefix forecaster states live on ``device`` (the
card unless the caller names another, as every entry point); the rest
is host bookkeeping, in the reference's order, so every ``cycle()``
returns the reference's diagnostics bit for bit.

A KV prefix cache is an *ad-hoc index over the request stream*: it
accelerates prefill for requests sharing a prompt prefix, costs HBM
proportional to its length, and its utility shifts with the workload
(system prompts change on deploys; traffic mixes are diurnal).  That
is exactly the physical-design problem of the paper, so the same three
components manage it:

* workload monitor     -> per-prefix hit statistics per cycle
* Holt-Winters model   -> forecast per-prefix utility (saved prefill
                          FLOPs) one cycle ahead; models survive
                          eviction, so recurring prefixes are re-built
                          AHEAD of their traffic (predictive DL)
* 0-1 knapsack         -> choose the prefix set under the HBM budget

and the analogue of the value-agnostic hybrid scan: prefixes are
materialised INCREMENTALLY, a bounded number of tokens per cycle, and
a partially materialised prefix already serves requests -- prefill
resumes from the covered page boundary (``covered_len``) instead of
waiting for full materialisation (no admission latency spikes).

Determinism contract: ``cycle`` is bit-deterministic for a given
lookup history, across Python hash seeds.  The bounded
``tokens_per_cycle`` build budget is allocated in a canonical order --
knapsack utility descending, prefix id ascending on ties -- and every
knapsack-chosen prefix is materialised (at ``covered_len=0`` when the
cycle's budget is spent), so the knapsack's decision is never silently
discarded and re-evicted next cycle.  Prefixes whose forecast AND
observed utility stay at zero for ``max_idle_cycles`` consecutive
cycles are aged out of the monitor entirely (a one-shot prefix must
not be forecast + knapsacked forever).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np

from repro_torch.core import forecaster as hw
from repro_torch.core import knapsack
from repro_torch.core.table import resolve_device

# A prefix whose observed and forecast utility both sit at (numerical)
# zero is dead traffic; real utilities are whole saved tokens, so
# anything below this is the forecaster's EPS floor decaying.
AGE_UTIL_EPS = 1e-3


@dataclass
class PrefixEntry:
    prefix_id: str
    length: int  # tokens in the full prefix
    covered_len: int = 0  # tokens materialised so far (VAP-style)
    bytes_per_token: float = 0.0
    hits_this_cycle: int = 0

    @property
    def size_bytes(self) -> float:
        return self.covered_len * self.bytes_per_token


@dataclass
class PredictivePrefixCache:
    """Cycle-driven predictive manager (no KV allocation here; the
    serve loop owns the actual KV blocks and obeys our decisions).
    ``device`` holds the forecaster states: ``cuda`` unless given."""

    hbm_budget_bytes: float
    bytes_per_token: float
    tokens_per_cycle: int = 4096  # bounded build work per cycle
    season_len: int = 24
    max_idle_cycles: int = 8  # zero-utility cycles before aging out
    entries: Dict[str, PrefixEntry] = field(default_factory=dict)
    models: Dict[str, hw.HWState] = field(default_factory=dict)
    known_lengths: Dict[str, int] = field(default_factory=dict)
    idle_cycles: Dict[str, int] = field(default_factory=dict)
    cycles: int = 0
    device: object = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    # ---- serving-path hooks -------------------------------------------
    def lookup(self, prefix_id: str, length: int) -> int:
        """Returns the number of prefix tokens the cache can serve
        (prefill resumes after them).  Partially-built prefixes serve
        their covered span -- the hybrid-scan property."""
        self.known_lengths[prefix_id] = length
        e = self.entries.get(prefix_id)
        if e is None:
            return 0
        e.hits_this_cycle += 1
        return min(e.covered_len, length)

    # ---- tuning cycle ----------------------------------------------------
    def cycle(self) -> Dict[str, float]:
        """One tuning cycle: observe utilities, forecast, knapsack,
        apply bounded build/evict actions.  Returns diagnostics."""
        # Stage I/III: observed utility = saved prefill tokens
        observed: Dict[str, float] = {}
        for pid in sorted(self.known_lengths):
            e = self.entries.get(pid)
            hits = e.hits_this_cycle if e else 0.0
            cov = e.covered_len if e else 0
            observed[pid] = float(hits) * cov
            st = self.models.get(pid)
            if st is None:
                st = hw.init_state(self.season_len, device=self.device)
            self.models[pid] = hw.update(st, observed[pid])

        forecasts = {
            pid: float(hw.forecast(self.models[pid], 1))
            for pid in self.models
        }

        # Age out dead prefixes: once forecast AND observed utility
        # have been zero for ``max_idle_cycles`` straight cycles, the
        # prefix leaves the monitor (known_lengths would otherwise
        # grow without bound and every cycle would forecast + knapsack
        # one-shot prefixes forever).  A returning prefix re-enters
        # through ``lookup`` with a fresh model.
        for pid in list(self.known_lengths):
            signal = max(observed.get(pid, 0.0), forecasts.get(pid, 0.0))
            if signal > AGE_UTIL_EPS:
                self.idle_cycles[pid] = 0
                continue
            idle = self.idle_cycles.get(pid, 0) + 1
            if idle < self.max_idle_cycles:
                self.idle_cycles[pid] = idle
                continue
            del self.known_lengths[pid]
            self.models.pop(pid, None)
            self.entries.pop(pid, None)
            self.idle_cycles.pop(pid, None)
            observed.pop(pid, None)
            forecasts.pop(pid, None)

        # Stage II: knapsack over known prefixes under the HBM budget
        pids = sorted(self.known_lengths)
        utility = {
            p: max(forecasts.get(p, 0.0), observed.get(p, 0.0))
            for p in pids
        }
        utils = np.array([utility[p] for p in pids])
        sizes = np.array(
            [self.known_lengths[p] * self.bytes_per_token for p in pids]
        )
        keep = (
            knapsack.solve(utils, sizes, self.hbm_budget_bytes)
            if pids
            else np.zeros(0, bool)
        )
        chosen = [pids[i] for i in range(len(pids)) if keep[i]]

        chosen_set = set(chosen)
        for pid in list(self.entries):
            if pid not in chosen_set:
                del self.entries[pid]  # evict; model survives

        # Bounded build budget, allocated in canonical order (forecast
        # utility descending, pid ascending on ties) so results are
        # independent of set/dict iteration order -- and EVERY chosen
        # prefix is materialised: a chosen-but-unfunded prefix keeps
        # its entry at covered_len=0 and resumes growing next cycle
        # instead of being silently re-evicted.
        chosen.sort(key=lambda p: (-utility[p], p))
        budget = self.tokens_per_cycle
        for pid in chosen:
            e = self.entries.get(pid)
            if e is None:
                e = PrefixEntry(
                    pid,
                    self.known_lengths[pid],
                    bytes_per_token=self.bytes_per_token,
                )
                self.entries[pid] = e
            grow = min(budget, e.length - e.covered_len)
            e.covered_len += grow
            budget -= grow
        for e in self.entries.values():
            e.hits_this_cycle = 0
        self.cycles += 1
        return {
            "n_entries": len(self.entries),
            "bytes": sum(e.size_bytes for e in self.entries.values()),
            "forecast_max": max(forecasts.values(), default=0.0),
        }
