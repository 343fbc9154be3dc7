"""Continuous batching of seed-node requests into one static batch shape
(the port's copy of ``repro.serve.batcher``, which imports no framework).

Serving traffic arrives as variable-size requests ("embed/classify these
seed nodes"); the device program wants one fixed ``(batch_size,)`` seed
vector per dispatch (the static shape fixes the sample plan — padding,
never re-planning).  The batcher bridges the two: requests queue at
per-seed granularity in one FIFO deque per priority rank, and each
``next_batch`` pulls items — higher priority classes first, arrival
order within a class — until the batch's *compute set* — unique seeds
the caller's classifier cannot resolve from cache — would exceed
``batch_size``.

Consequences of that rule:

- a request larger than the batch size splits across consecutive
  batches and completes when its last row resolves;
- duplicate seeds across (or within) queued requests collapse to one
  compute slot — cross-request dedup: a hot node is sampled/gathered
  once per batch and fanned back out to every requester;
- cache-warm rows ride along for free (they cost one gather row, not a
  program slot), so a warm burst drains in a single step;
- a high-priority request never waits behind queued low-priority rows:
  low-priority backlog drains only after every higher rank is empty.

``shed`` removes queued rows of requests the caller declares dead
(deadline passed) before they reach a batch — their compute cost is
never paid.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class ServeRequest:
    """One in-flight request: ``rows[i]`` fills as seed ``seeds[i]``
    resolves; done when ``remaining`` hits zero.  ``rank`` is the
    scheduling rank (0 drains first); ``deadline`` is an absolute clock
    value after which the request is shed instead of served; ``status``
    is ``pending`` -> ``done`` | ``expired``."""
    rid: int
    seeds: np.ndarray
    t_submit: float
    priority: str = "high"
    rank: int = 0
    deadline: Optional[float] = None
    rows: List[Optional[tuple]] = dataclasses.field(default_factory=list)
    remaining: int = 0
    t_done: Optional[float] = None
    status: str = "pending"

    def __post_init__(self):
        self.seeds = np.asarray(self.seeds, np.int64).reshape(-1)
        if len(self.seeds) == 0:
            raise ValueError("a serve request needs at least one seed id")
        self.rows = [None] * len(self.seeds)
        self.remaining = len(self.seeds)

    def resolve(self, row_index: int, payload: tuple):
        if self.rows[row_index] is None:
            self.remaining -= 1
        self.rows[row_index] = payload

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline


class ContinuousBatcher:
    """Priority-ranked FIFO request queues -> per-step work orders (see
    module docstring)."""

    def __init__(self, batch_size: int):
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        self.batch_size = int(batch_size)
        self._queues: Dict[int, deque] = {}   # rank -> (req, row, seed)

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def add(self, req: ServeRequest):
        q = self._queues.setdefault(int(req.rank), deque())
        for i, s in enumerate(req.seeds):
            q.append((req, i, int(s)))

    def shed(self, should_shed: Callable[[ServeRequest], bool]
             ) -> List[tuple]:
        """Remove every queued item whose request ``should_shed``;
        returns the removed ``(request, row_index, seed)`` triples (the
        caller marks the requests expired and releases their admission
        budget).  Memoized per request so the predicate runs once per
        distinct request, not once per row."""
        verdict: Dict[int, bool] = {}

        def dead(req):
            v = verdict.get(req.rid)
            if v is None:
                v = verdict[req.rid] = bool(should_shed(req))
            return v

        removed: List[tuple] = []
        for rank, q in self._queues.items():
            kept = deque()
            for item in q:
                (removed if dead(item[0]) else kept).append(item)
            self._queues[rank] = kept
        return removed

    def peek_compute_ids(self, is_cached: Callable[[int], bool]
                         ) -> List[int]:
        """Dry run of ``next_batch``: the compute set the next call would
        pull, without consuming the queues.  The serving prefetch peeks
        at the upcoming batch to dispatch its program call while the
        current batch's rows are still resolving on host."""
        compute: List[int] = []
        in_compute = set()
        for rank in sorted(self._queues):
            for _req, _row, seed in self._queues[rank]:
                if seed not in in_compute and not is_cached(seed):
                    if len(compute) == self.batch_size:
                        return compute
                    compute.append(seed)
                    in_compute.add(seed)
        return compute

    def next_batch(self, is_cached: Callable[[int], bool]
                   ) -> Tuple[List[tuple], List[int]]:
        """Pull the next batch's items off the queues, best rank first.

        Returns ``(items, compute_ids)``: ``items`` are the
        ``(request, row_index, seed)`` triples this batch serves, in
        rank-then-arrival order; ``compute_ids`` are the unique seeds the
        program must compute (first-seen order, ``<= batch_size`` of
        them — pad-to-batch is the caller's job).  ``is_cached(seed)``
        says a seed resolves from cache without a compute slot; it must
        be stable for the duration of the call."""
        items: List[tuple] = []
        compute: List[int] = []
        in_compute = set()
        for rank in sorted(self._queues):
            q = self._queues[rank]
            while q:
                req, row, seed = q[0]
                if seed not in in_compute and not is_cached(seed):
                    if len(compute) == self.batch_size:
                        return items, compute   # next batch starts here
                    compute.append(seed)
                    in_compute.add(seed)
                items.append((req, row, seed))
                q.popleft()
        return items, compute
