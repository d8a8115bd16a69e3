"""Async tuning pipeline: the decide/apply split over incremental builds.

Port of ``repro.core.build_service``.  The paper's claim is that
continuous, lightweight physical-design changes beat stop-the-world
tuning, which holds only if index construction proceeds *while*
queries run.  This module is the pipeline between the tuner and the
scans:

* ``PredictiveTuner.decide`` runs the pure decision stages of
  Algorithm 1 and returns a ``CyclePlan`` whose build work is an
  ordered list of ``BuildQuantum`` records instead of being executed
  inline.
* ``BuildService`` queues those quanta and applies them one at a time
  (``Database.vap_build_step``).  In overlap mode the engine drains
  the queue between the grouped dispatches of a read burst
  (``ScanEngine.after_dispatch``), so builds run between the hot
  path's kernels instead of stalling them; in-flight queries keep the
  plans the planner minted against the catalog it froze at burst
  start (``QueryPlanner.begin_snapshot``) while quanta advance the
  live indexes.  The hybrid scan's ``start_page`` prefix makes a
  partially advanced build safe: every page outside the indexed
  prefix is table-scanned.
* Quanta that could not be drained inside a burst stay queued (the
  cycle-budget carryover); a quantum whose index was dropped or
  finished by a later decide step is skipped at apply time.

Snapshot rule.  No quantum writes in place into an index state that a
pinned plan holds.  The reference gets this from immutable JAX arrays;
in the port every build (``build_pages_vap``, ``build_page_list``, the
sharded ``replace_shards``) returns new tensors and rebinds
``BuiltIndex.vap``, and ``PageCoverage``, which bitmap-mode quanta do
mutate in place, is pinned as a ``CoverageView`` that copies the host
bits and memoises its device tensors per version.  Any faster merge
(an O(n) merge of new entries into the sorted old ones) must keep
this rule: write into fresh tensors, or copy before writing.

Bit-exactness (deterministic mode).  ``RunConfig.async_tuning ==
"deterministic"`` replays the serialized schedule through the split
pipeline: every due cycle runs ``decide`` and then drains the whole
queue before the burst executes.  ``decide`` does the arithmetic of
``tuning_cycle`` in the same order and the drained quanta are the
same slices applied in the same order, so results AND the cost /
clock / monitor accounting equal serialized tuning for any shard
count.  ``"overlap"`` relaxes only the schedule: quanta ride a
concurrent build lane between burst dispatches, and their work never
enters the blocking path.

Bitmap-mode quanta (coverage indexes) keep replay deterministic: the
tuner derives a ``page_list`` from deterministic inputs only (monitor
records, zone maps, the bitmap); ``vap_build_step`` filters it against
the live bitmap at apply time, so a stale quantum is a no-op; and
``decide`` slices a list in order, so any quantum size applies the
same pages in the same sequence.

Wall time.  ``apply_next`` times each applied quantum to keep the
lane's throughput model (``pages_per_ms``, an EWMA).  On the card a
build is a queue of asynchronous launches, so the timer synchronises
the device before and after ``apply_quantum``: the rate is the
device's build time, not the launch time.  The model is telemetry,
as in the reference: no simulated quantity reads it, except the
reference's own wall-clock paths -- ``drain_burst_size`` once the
queue is over ``max_queue_depth``, and ``suggested_pages_per_cycle``
behind ``RunConfig.adaptive_build_budget`` -- which a run that must
replay bit for bit keeps off (``build_escalations == 0``, adaptive
sizing off).

Replica lanes.  On a ``core.replica.ReplicaSet`` a quantum's
``replica`` tag picks the catalogs it builds on (``build_targets``):
``None`` applies the same slice to every replica and charges the max
(mirrored replicas are parallel machines), an id builds on that
replica alone.  ``drain`` groups the queue by lane and charges the
max over the lanes' totals.  A plain ``Database`` is one lane.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field, replace
from typing import Deque, List, Optional, Tuple

import torch

from repro_torch import telemetry
from repro_torch.core.index import split_build_pages

# EWMA weight for the build-lane throughput model (pages/ms).
THROUGHPUT_EWMA_ALPHA = 0.25
# Wall-time budget for one escalated drain opportunity: backpressure
# raises how many quanta a drain applies, but the measured throughput
# model caps the burst so the lane's real time per opportunity stays
# bounded (an unbounded burst would be a stall).
MAX_DRAIN_BURST_MS = 5.0
# Utility cut for pressure-time drains (BuildService.drain_urgent):
# quanta at or above this fraction of the queue's max decide-time
# utility are the capacity-restoring share and drain through a storm;
# the rest is speculative prebuild work that can wait for an idle gap.
URGENT_UTILITY_FRAC = 0.5
# Adaptive cycle sizing (RunConfig.adaptive_build_budget): target wall
# time for draining ONE cycle's build slice on the concurrent lane.
CYCLE_DRAIN_TARGET_MS = 10.0


@dataclass(frozen=True)
class BuildQuantum:
    """One interleavable slice of index-build work."""

    index_name: str
    pages: int
    # None = advance the global prefix (round-robin over shards on
    # sharded storage); an int targets that shard's local prefix.
    shard: Optional[int] = None
    # Forecast utility of the owning index at decide time.  Ranks
    # queued quanta for load shedding and urgent drains; it does not
    # affect the build arithmetic.
    utility: float = 0.0
    # Explicit global page ids for bitmap-mode (coverage) indexes:
    # hot-range-first scheduling.  Empty = build the lowest uncovered
    # pages (coverage) or advance the prefix (legacy).  ``pages`` is
    # the slice budget either way (== len(page_list) when present).
    page_list: tuple = ()
    # Build lane (core.replica): ``None`` applies to every replica --
    # on a plain Database, to that database -- and is charged once;
    # an id targets that replica's catalog alone (divergent tuning).
    replica: Optional[int] = None
    # Fault-injection retry counter: how many apply attempts of this
    # quantum have already failed (0 on freshly planned quanta).
    attempt: int = 0


@dataclass
class CyclePlan:
    """Output of a tuner's decide step: pending build work + the work
    units the decision stages themselves consumed."""

    quanta: List[BuildQuantum] = field(default_factory=list)
    decide_work: float = 0.0


def _targets(db, replica: Optional[int]):
    """The catalogs a quantum of lane ``replica`` applies to: a replica
    set's ``build_targets``, else the database itself."""
    targets = getattr(db, "build_targets", None)
    return targets(replica) if targets is not None else (db,)


def apply_quantum(db, quantum: BuildQuantum) -> float:
    """Apply one build quantum against the live catalog(s); returns
    work units.  A target whose index was dropped or finished since
    the quantum was planned is skipped.  On a replica set the
    quantum's ``replica`` tag resolves the targets first and the
    charge is the max over them (replicas build in parallel)."""
    work = 0.0
    for d in _targets(db, quantum.replica):
        bi = d.indexes.get(quantum.index_name)
        if bi is None or not bi.building or bi.scheme not in ("vap", "full"):
            continue
        with telemetry.span("index.build"):
            w = d.vap_build_step(bi, quantum.pages, shard=quantum.shard,
                                 page_list=quantum.page_list or None)
        work = max(work, w)
    return work


def _sync(db) -> None:
    """Wait for the database's device (a no-op off the card)."""
    dev = getattr(db, "device", None)
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)


class BuildService:
    """Quantum queue between a tuner's decide step and the engine.

    ``quantum_pages`` sub-slices each cycle's per-index build step for
    finer interleaving (overlap mode); ``None`` keeps the serialized
    slice sizes, which deterministic mode requires.  Tuners without a
    ``decide`` method (the baseline tuners) run their monolithic
    ``tuning_cycle`` inside ``decide``.

    The service keeps a throughput model of the lane (an EWMA of
    measured pages/ms per applied quantum) and applies backpressure:
    when the queue is deeper than ``max_queue_depth``,
    ``drain_burst_size`` escalates how many quanta each drain
    opportunity applies.

    With a fault ``injector``, each apply attempt asks
    ``injector.build_fault()`` BEFORE touching the catalog, so a
    failed attempt applies nothing.  Recovery on: the quantum waits
    out an exponential backoff (``backoff_ms * 2**attempt`` on the
    simulated clock) in ``retry_queue`` and is quarantined after
    ``max_attempts`` failures (its index stops building, which
    releases its budget share at the next decide).  Recovery off: a
    failed quantum is dropped.
    """

    def __init__(
        self,
        db,
        tuner,
        quantum_pages: Optional[int] = None,
        max_queue_depth: Optional[int] = None,
        injector=None,
        max_attempts: int = 4,
        backoff_ms: float = 4.0,
    ):
        self.db = db
        self.tuner = tuner
        self.quantum_pages = quantum_pages
        self.max_queue_depth = max_queue_depth
        self.queue: Deque[BuildQuantum] = deque()
        # throughput model + backpressure telemetry
        self.pages_per_ms: float = 0.0   # EWMA; 0.0 until first drain
        self.drained_quanta: int = 0
        self.escalations: int = 0
        # Load-aware throttle (serving front end): while paused, drain
        # opportunities apply nothing.
        self.paused: bool = False
        self.shed_quanta: int = 0
        # Fault-injected apply retry: a separate queue of
        # (due clock ms, sequence, quantum), so ``drain``'s
        # whole-queue loop terminates.
        self.injector = injector
        self.max_attempts = max_attempts
        self.backoff_ms = backoff_ms
        self.retry_queue: List[Tuple[float, int, BuildQuantum]] = []
        self._retry_seq = 0
        self.failed_applies: int = 0
        self.retried_quanta: int = 0
        self.dropped_quanta: int = 0
        self.quarantined: List[BuildQuantum] = []

    # -- decide: enqueue the cycle's build work --------------------------
    def decide(self, idle: bool = False) -> float:
        """Run the tuner's decision stages; queue the build quanta.
        Returns the decide-stage work units (charged by the caller
        like cycle work)."""
        decide_fn = getattr(self.tuner, "decide", None)
        if decide_fn is None:
            # Baseline tuner: the whole cycle is one non-interleavable
            # unit of work, applied immediately.
            return self.tuner.tuning_cycle(idle=idle)
        plan = decide_fn(idle=idle)
        for q in plan.quanta:
            if q.page_list:
                # Slice the explicit page list in order: any quantum
                # size applies the same pages in the same sequence.
                pl = list(q.page_list)
                step = self.quantum_pages or len(pl)
                for i in range(0, len(pl), step):
                    chunk = tuple(pl[i:i + step])
                    self.queue.append(
                        BuildQuantum(q.index_name, len(chunk), q.shard,
                                     q.utility, chunk, q.replica)
                    )
                continue
            for pages in split_build_pages(q.pages, self.quantum_pages):
                self.queue.append(
                    BuildQuantum(q.index_name, pages, q.shard, q.utility,
                                 replica=q.replica)
                )
        return plan.decide_work

    # -- apply: drain quanta ---------------------------------------------
    def pending(self) -> int:
        """Applicable quanta right now: due retries are admitted first;
        retries not yet due are NOT counted (callers loop on
        ``pending()``, and work that cannot start before a future
        deadline would spin them forever)."""
        self._admit_due_retries()
        return len(self.queue)

    def _admit_due_retries(self) -> None:
        """Move retry quanta whose backoff deadline has passed (on the
        simulated clock) back onto the main queue, oldest deadline
        first (ties by re-queue sequence)."""
        if not self.retry_queue:
            return
        now = getattr(self.db, "clock_ms", 0.0)
        due = [e for e in self.retry_queue if e[0] <= now]
        if not due:
            return
        self.retry_queue = [e for e in self.retry_queue if e[0] > now]
        for _, _, quantum in sorted(due, key=lambda e: (e[0], e[1])):
            self.queue.append(quantum)

    def _on_build_failure(self, quantum: BuildQuantum) -> None:
        """A fault-injected apply attempt failed (nothing was applied):
        re-queue with backoff, quarantine, or drop."""
        self.failed_applies += 1
        if self.injector is None or not self.injector.recovery:
            self.dropped_quanta += 1
            return
        nxt = replace(quantum, attempt=quantum.attempt + 1)
        if nxt.attempt >= self.max_attempts:
            self.quarantined.append(nxt)
            self._quarantine_index(nxt)
            return
        self.retried_quanta += 1
        delay = self.backoff_ms * (2.0 ** quantum.attempt)
        now = getattr(self.db, "clock_ms", 0.0)
        self.retry_queue.append((now + delay, self._retry_seq, nxt))
        self._retry_seq += 1

    def _quarantine_index(self, quantum: BuildQuantum) -> None:
        """Permanently failing quantum: stop building its index, which
        releases its budget share at the tuner's next decide and makes
        queued sibling quanta stale no-ops (on every catalog of the
        quantum's lane)."""
        for d in _targets(self.db, quantum.replica):
            bi = d.indexes.get(quantum.index_name)
            if bi is not None and bi.building:
                bi.building = False

    def apply_next(self) -> float:
        """Apply the oldest queued quantum; returns its work units (0.0
        on an empty queue, a stale quantum, or a failed attempt).
        Every applied quantum feeds the throughput model with its
        device time (telemetry only)."""
        self._admit_due_retries()
        if not self.queue:
            return 0.0
        quantum = self.queue.popleft()
        if self.injector is not None and self.injector.build_fault():
            self._on_build_failure(quantum)
            return 0.0
        _sync(self.db)
        t0 = time.perf_counter()
        work = apply_quantum(self.db, quantum)
        if work > 0.0:
            _sync(self.db)
            dt_ms = max((time.perf_counter() - t0) * 1e3, 1e-6)
            rate = quantum.pages / dt_ms
            a = THROUGHPUT_EWMA_ALPHA
            if self.pages_per_ms == 0.0:
                self.pages_per_ms = rate
            else:
                self.pages_per_ms = (1.0 - a) * self.pages_per_ms + a * rate
            self.drained_quanta += 1
        return work

    # -- throughput model + backpressure ---------------------------------
    def drain_burst_size(self) -> int:
        """How many quanta the next drain opportunity should apply: one
        in steady state; past ``max_queue_depth``, ceil(depth / cap),
        shrunk until its ``estimated_drain_ms`` fits
        ``MAX_DRAIN_BURST_MS``."""
        depth = len(self.queue)
        if depth == 0 or self.paused:
            return 0
        if self.max_queue_depth is None or depth <= self.max_queue_depth:
            return 1
        self.escalations += 1
        burst = -(-depth // self.max_queue_depth)
        if self.pages_per_ms > 0.0:
            pages = [q.pages for q in itertools.islice(self.queue, burst)]
            while burst > 1:
                est = self.estimated_drain_ms(sum(pages[:burst]))
                if est <= MAX_DRAIN_BURST_MS:
                    break
                burst -= 1
        return burst

    def estimated_drain_ms(self, pages: Optional[int] = None) -> float:
        """Measured-throughput estimate of draining ``pages`` build
        pages (default: the whole queue); inf before the model has a
        measurement."""
        if pages is None:
            pages = sum(q.pages for q in self.queue)
        if pages <= 0:
            return 0.0
        if self.pages_per_ms <= 0.0:
            return float("inf")
        return pages / self.pages_per_ms

    def suggested_pages_per_cycle(
        self, target_ms: float = CYCLE_DRAIN_TARGET_MS
    ) -> Optional[int]:
        """The page count whose drain fits ``target_ms`` at the current
        EWMA pages/ms; None before the model has a measurement."""
        if self.pages_per_ms <= 0.0:
            return None
        return max(int(self.pages_per_ms * target_ms), 1)

    def shed_lowest_utility(self, max_keep: int) -> int:
        """Load shedding: drop queued quanta until at most ``max_keep``
        remain, utility ascending, then oldest first on ties.  Under
        overload the serving layer sheds tuning work, never queries.
        Returns the number dropped."""
        drop = len(self.queue) - max(int(max_keep), 0)
        if drop <= 0:
            return 0
        order = sorted(
            range(len(self.queue)),
            key=lambda i: (self.queue[i].utility, i),
        )
        victims = set(order[:drop])
        self.queue = deque(
            q for i, q in enumerate(self.queue) if i not in victims
        )
        self.shed_quanta += drop
        return drop

    def drain(self) -> float:
        """Apply every queued quantum (the deterministic boundary
        drain); returns the charged work units: the max over build
        lanes (``BuildQuantum.replica``) of each lane's total, since
        replicas build in parallel.  A single engine's quanta sit on
        the one ``None`` lane, where the max is the sum.  Only due
        retries take part, so the loop ends even when every attempt
        fails."""
        self._admit_due_retries()
        lane_work: dict = {}
        while self.queue:
            lane = self.queue[0].replica
            lane_work[lane] = lane_work.get(lane, 0.0) + self.apply_next()
        return max(lane_work.values(), default=0.0)

    def drain_urgent(self, frac: float = URGENT_UTILITY_FRAC) -> float:
        """Pressure-time partial drain: apply only the quanta whose
        decide-time utility reaches ``frac`` of the queue's maximum;
        the rest stays queued, in order.  With no utility spread
        everything is urgent and this is ``drain``.  Returns the
        applied work units."""
        if not self.queue:
            return 0.0
        cut = frac * max(q.utility for q in self.queue)
        backlog = list(self.queue)
        self.queue = deque(q for q in backlog if q.utility >= cut)
        work = self.drain()
        self.queue = deque(q for q in backlog if q.utility < cut)
        return work
