"""Batched request scheduler for the serve loop.

Port of ``repro.serving.scheduler``, line for line: host-only numpy,
no device state.

Continuous-batching-lite: requests queue up, the scheduler packs up to
``max_batch`` of them per step, pads to the batch shape the compiled
decode step expects, and retires sequences that hit EOS or their token
budget.  The prefix cache (serving/prefix_cache.py) is consulted at
admission to skip covered prefill spans.

Liveness contract: every submitted request eventually retires, so a
drained serve loop always reaches ``idle``.  Two historical leaks are
closed at the door:

* a request with ``max_new_tokens <= 0`` can never satisfy the
  ``len(generated) >= max_new_tokens`` retirement check from inside a
  decode step (no step will ever report a token for it), so it is
  clamped at ``submit`` and retired at admission without taking a
  slot;
* a request whose rid stops appearing in step outputs (evicted batch
  lane, server-side stop) is still budget-checked every step, so its
  slot is released the moment its budget is spent instead of being
  held forever.
"""

from __future__ import annotations

import collections
import itertools
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

import numpy as np


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (len,) int32
    max_new_tokens: int = 32
    prefix_id: Optional[str] = None
    generated: List[int] = field(default_factory=list)
    done: bool = False


@dataclass
class BatchScheduler:
    max_batch: int
    eos_id: int = -1  # -1: only budget-based termination
    queue: Deque[Request] = field(default_factory=collections.deque)
    active: List[Request] = field(default_factory=list)
    retired: int = 0
    _ids: "itertools.count" = field(default_factory=itertools.count)

    def submit(
        self,
        prompt: np.ndarray,
        max_new_tokens: int = 32,
        prefix_id: Optional[str] = None,
    ) -> int:
        """Queue one request; the token budget is clamped to >= 0 (a
        negative budget is a caller bug that must not leak a slot)."""
        rid = next(self._ids)
        budget = max(int(max_new_tokens), 0)
        self.queue.append(
            Request(rid, np.asarray(prompt, np.int32), budget, prefix_id)
        )
        return rid

    def admit(self) -> List[Request]:
        """Fill free slots from the queue; returns the newly admitted
        requests.  Zero-budget requests are retired here (``done``,
        never occupying a slot): no decode step will ever produce a
        token for them, so parking them in ``active`` would hold the
        slot forever and ``idle`` would be unreachable."""
        new = []
        while self.queue and len(self.active) < self.max_batch:
            r = self.queue.popleft()
            if r.max_new_tokens <= 0:
                r.done = True
                self.retired += 1
                continue
            self.active.append(r)
            new.append(r)
        return new

    def record_tokens(self, tokens: Dict[int, int]) -> None:
        """Feed one decode step's outputs {rid: token}.

        Every active request is budget-checked -- not just the rids
        present in ``tokens`` -- so a request the decode step stopped
        reporting still releases its slot once its budget is spent.
        """
        for r in self.active:
            t = tokens.get(r.rid)
            if t is not None:
                r.generated.append(int(t))
                if int(t) == self.eos_id:
                    r.done = True
            if len(r.generated) >= r.max_new_tokens:
                r.done = True
        self.retired += sum(1 for r in self.active if r.done)
        self.active = [r for r in self.active if not r.done]

    @property
    def idle(self) -> bool:
        return not self.queue and not self.active
