"""The harness's timers and records around the calls the runner makes.

``Probes`` wraps, on one ``Database`` and its tuner, the entry points
the closed loop calls -- ``execute_batch`` (a read burst),
``execute`` (one statement) and the tuner's ``tuning_cycle`` -- and
the planner's ``plan_scan``.  It records, on the host clock:

* every statement answered, in order, with its answer;
* each call's completion time, from which a statement's closed-loop
  latency is the time from the completion of the previous call that
  served the client to the completion of the call that served it (a
  burst's statements share their burst's value);
* which access path the planner chose for each scan.

Traced (``traced=True``) it also records each call's span on the wall
clock the profiler's trace uses (``time.time_ns``), times each burst
and tuning cycle (a cycle's timer closes on a device synchronise),
counts the pages built into the indexes after each call from their own
built counts and coverage, and records the shapes of every K1 and K3
launch for their bounds.
Nothing here edits the program: the wrappers sit on the instances and
on the kernel module's attributes, and ``remove`` puts them back.
"""

from __future__ import annotations

import time
from collections import Counter

import torch


class Probes:
    def __init__(self, db, tuner, traced: bool):
        self.db, self.tuner, self.traced = db, tuner, traced
        self.answered = []      # (statement object, (sum, count, rows))
        self.calls = []         # (completion s, statements served)
        self.burst_walls = []   # seconds per execute_batch (traced)
        self.cycle_walls = []   # seconds per tuning_cycle (traced)
        self.plans = Counter()
        # Per K1 launch: (pages, page size, planes, start pages); per K3
        # launch: (page size, planes, queries, words, local pages).
        self.k1, self.k3 = [], []
        self.spans = []         # (start ns, end ns, call) on the wall clock
        self.vap_pages = 0
        self._built = {}        # id(index entry) -> pages seen built
        self._depth = 0
        self._saved = []
        self._install()

    # -- installation -----------------------------------------------------
    def _patch(self, owner, name, wrapper):
        self._saved.append((owner, name, owner.__dict__.get(name)))
        setattr(owner, name, wrapper)

    def remove(self) -> None:
        for owner, name, old in reversed(self._saved):
            if old is None:
                delattr(owner, name)
            else:
                setattr(owner, name, old)
        self._saved.clear()

    def _span(self, name, a_ns: int) -> None:
        if self.traced:
            self.spans.append((a_ns, time.time_ns(), name))

    def _install(self) -> None:
        db, tuner = self.db, self.tuner
        batch, single = db.execute_batch, db.execute
        cycle, plan = tuner.tuning_cycle, db.planner.plan_scan

        def execute_batch(queries, *a, **k):
            if self._depth:  # called from inside the program
                return batch(queries, *a, **k)
            return self._served("execute_batch", lambda: batch(
                queries, *a, **k), queries)

        def execute(q, *a, **k):
            if self._depth:
                return single(q, *a, **k)
            return self._served("execute", lambda: [single(q, *a, **k)],
                                [q])[0]

        def tuning_cycle(*a, **k):
            a_ns, t0 = time.time_ns(), time.perf_counter()
            out = cycle(*a, **k)
            if self.traced:
                if db.device.type == "cuda":
                    torch.cuda.synchronize(db.device)
                self.cycle_walls.append(time.perf_counter() - t0)
                self._span("tuning_cycle", a_ns)
                self._count_built()
            return out

        def plan_scan(q):
            p = plan(q)
            self.plans[p.path] += 1
            return p

        self._patch(db, "execute_batch", execute_batch)
        self._patch(db, "execute", execute)
        self._patch(tuner, "tuning_cycle", tuning_cycle)
        self._patch(db.planner, "plan_scan", plan_scan)
        if self.traced:
            self._install_kernels()

    def _served(self, name, call, queries):
        self._depth += 1
        try:
            a_ns, t0 = time.time_ns(), time.perf_counter()
            out = call()
            done = time.perf_counter()
        finally:
            self._depth -= 1
        self._span(name, a_ns)
        self.calls.append((done, len(queries)))
        if self.traced and name == "execute_batch":
            self.burst_walls.append(done - t0)
        for q, s in zip(queries, out):
            self.answered.append(
                (q, None if s is None else (s.agg_sum, s.count,
                                            s.rows_modified)))
        if self.traced:
            self._count_built()
        return out

    def _count_built(self) -> None:
        """Add the pages built into each index since the last look (an
        index's own built-page count, or its coverage bitmap's)."""
        for bi in self.db.indexes.values():
            if bi.coverage is not None:
                now = int(bi.coverage.count())
            elif bi.vap is not None:
                now = int(getattr(bi.vap, "built_pages", 0))
            else:
                continue
            seen = self._built.get(id(bi), 0)
            if now > seen:
                self.vap_pages += now - seen
            self._built[id(bi)] = now

    def _install_kernels(self) -> None:
        from repro_torch.kernels import batched_filter_agg as bfa

        k1, k3 = bfa.batched_filter_agg, bfa.sharded_batched_filter_agg_masked

        def planes_of(args):
            return len({x.data_ptr() for x in args[:5]})

        def batched_filter_agg(*args, **kw):
            n_pages, page_size = args[0].shape
            self.k1.append((n_pages, page_size, planes_of(args),
                            args[10].detach().clone()))
            return k1(*args, **kw)

        def masked(*args, **kw):
            page_size = args[0].shape[-1]
            self.k3.append((page_size, planes_of(args), args[5].shape[0],
                            args[10].detach().clone(),
                            args[11].detach().clone()))
            return k3(*args, **kw)

        self._patch(bfa, "batched_filter_agg", batched_filter_agg)
        self._patch(bfa, "sharded_batched_filter_agg_masked", masked)

    # -- readings ---------------------------------------------------------
    def statements(self) -> int:
        return sum(n for _, n in self.calls)

    def latencies_ms(self, t0: float):
        """Each statement's closed-loop latency, in ms."""
        out, prev = [], t0
        for done, n in self.calls:
            out += [(done - prev) * 1e3] * n
            prev = done
        return out
