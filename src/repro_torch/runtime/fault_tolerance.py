"""Fault tolerance and straggler mitigation for the training loop:
``repro.runtime.fault_tolerance``, copied (pure Python; the port
imports nothing of the reference).

``FaultTolerantLoop`` wraps a step function with:

* periodic checkpointing (delegated to CheckpointManager),
* automatic restore-and-replay after a failure (any exception from the
  step, or an injected fault in tests) -- the loop restarts from the
  last committed step and recomputes forward deterministically,
* bounded retry with escalation (after ``max_retries`` consecutive
  failures of the same step the error is re-raised for the scheduler
  to reallocate hardware),
* straggler mitigation for the host-side input pipeline: batches are
  produced by a prefetch thread with a deadline; a late batch is
  replaced by the backup batch (duplicate of the previous one) so the
  collective-synchronised device step never stalls behind one slow
  host (the "backup task" trick at the data layer).  Duplicated
  batches are counted and reported.

On real multi-pod deployments the heartbeat would feed the cluster
scheduler; here ``Heartbeat`` appends to a local file so tests can
assert liveness semantics.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator, Optional

from repro_torch.runtime.checkpoint import CheckpointManager


@dataclass
class Heartbeat:
    path: str
    interval_s: float = 5.0
    _stop: threading.Event = field(default_factory=threading.Event)
    _thread: Optional[threading.Thread] = None

    def start(self):
        def beat():
            while not self._stop.wait(self.interval_s):
                with open(self.path, "a") as f:
                    f.write(f"{time.time()}\n")
        self._thread = threading.Thread(target=beat, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=1.0)


class PrefetchWithBackup:
    """Iterator wrapper: produces batches on a worker thread; if the
    next batch misses the deadline, re-serves the previous batch (a
    backup) instead of stalling the synchronous device step."""

    def __init__(self, it: Iterator, deadline_s: float = 1.0,
                 capacity: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=capacity)
        self._deadline = deadline_s
        self._last = None
        self.stale_served = 0
        self._done = False

        def pump():
            for item in it:
                self._q.put(item)
            self._done = True

        self._thread = threading.Thread(target=pump, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        try:
            item = self._q.get(timeout=self._deadline)
            self._last = item
            return item
        except queue.Empty:
            if self._done and self._q.empty():
                raise StopIteration
            if self._last is None:   # nothing to back up with yet
                item = self._q.get()
                self._last = item
                return item
            self.stale_served += 1
            return self._last


@dataclass
class FaultTolerantLoop:
    step_fn: Callable          # (state, batch) -> (state, metrics)
    ckpt: CheckpointManager
    save_every: int = 50
    max_retries: int = 3

    def run(self, state: Any, batches: Iterator, n_steps: int,
            start_step: int = 0, fault_injector: Optional[Callable] = None):
        """Run ``n_steps`` with checkpoint/restart.

        ``fault_injector(step)`` may raise to simulate node failures
        (tests use this to assert recovery semantics).  Returns
        (state, metrics_history, recovery_count).
        """
        step = start_step
        retries = 0
        recoveries = 0
        history = []
        batch_buf = []   # replay buffer since last checkpoint
        it = iter(batches)

        if self.ckpt.latest_step() is not None:
            step, state = self.ckpt.restore_step(state)
            step += 1

        while step < n_steps:
            try:
                if batch_buf and len(batch_buf) > step % self.save_every:
                    batch = batch_buf[step % self.save_every]
                else:
                    batch = next(it)
                    batch_buf.append(batch)
                if fault_injector is not None:
                    fault_injector(step)
                state, metrics = self.step_fn(state, batch)
                history.append(metrics)
                retries = 0
                if (step + 1) % self.save_every == 0:
                    self.ckpt.save(step, state)
                    batch_buf = []
                step += 1
            except StopIteration:
                break
            except Exception:
                retries += 1
                recoveries += 1
                if retries > self.max_retries:
                    raise
                last = self.ckpt.latest_step()
                if last is not None:
                    step, state = self.ckpt.restore_step(state)
                    step += 1
                else:
                    step = start_step
                # deterministic replay resumes from the buffered batches
        return state, history, recoveries
