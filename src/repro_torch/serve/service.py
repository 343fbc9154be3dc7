"""Batched GNN inference serving on the device (the port's copy of
``repro.serve.service``, without admission control and cache
persistence, which are not ported yet).

``GSgnnInferenceService`` glues the serving pieces together:

- a :class:`~repro_torch.serve.batcher.ContinuousBatcher` packs queued
  seed-node requests into the device program's one static batch shape
  (padding partial batches), splitting oversized requests,
  deduplicating seeds across requests, and draining higher priority
  classes first; queued requests whose deadline passes are shed before
  they cost a compute slot;
- the inferer's :class:`~repro_torch.trainer.trainers.DeviceInferProgram`
  computes embeddings/logits for the batch's unique cold seeds — one
  sample -> gather -> GNN -> head pass on the device;
- a :class:`~repro_torch.serve.cache.DeviceEmbeddingCache` keeps
  computed rows device-resident, so warm seeds resolve via one device
  gather and skip message passing entirely, with staleness-bounded
  refresh: an entry older than ``max_staleness_steps`` program steps is
  recomputed.

Determinism contract: the inference program's draws are *seed-keyed*
(``DeviceNeighborSampler.sample(seed_keyed=True)``) — a seed's sampled
subtree is a pure function of its node id, independent of batch
composition, padding, position, and the step counter — and the kernels
use no atomics.  Every served row is therefore bit-identical to
``trainer.infer_device([seed], batch_size)`` at the same batch size,
however requests are batched or split.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.sampling import pad_seeds
from repro_torch.serve.batcher import ContinuousBatcher, ServeRequest
from repro_torch.serve.cache import DeviceEmbeddingCache

# priority class names (scheduling rank = position)
_PRIORITY_ORDER = ("high", "low")


class LatencyRing:
    """Fixed-size ring of the last 2048 completed-request latencies.
    ``record`` is O(1); ``summary`` computes p50/p99/req_per_s over the
    window."""

    capacity = 2048

    def __init__(self):
        self._buf = np.zeros(self.capacity, np.float64)
        self._n = 0                       # total recorded
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None

    def record(self, latency_s: float, now: float) -> None:
        self._buf[self._n % self.capacity] = latency_s
        self._n += 1
        if self._t_first is None:
            self._t_first = now
        self._t_last = now

    def summary(self) -> dict:
        if self._n == 0:
            return {"window": 0}
        lat = self._buf[:min(self._n, self.capacity)] * 1e3
        out = {"window": self._n,
               "p50_ms": float(np.percentile(lat, 50)),
               "p99_ms": float(np.percentile(lat, 99))}
        span = (self._t_last or 0.0) - (self._t_first or 0.0)
        out["req_per_s"] = float(self._n / max(span, 1e-9))
        return out


def request_stream(num_nodes: int, num_requests: int = 64,
                   request_size: int = 4, hot_fraction: float = 0.8,
                   hot_set: int = 64, seed: int = 0) -> List[np.ndarray]:
    """Synthetic serving traffic: each request draws ``request_size``
    seed ids, from a small hot set with probability ``hot_fraction``
    (the skewed production shape cross-request dedup and the cache are
    built for), else uniformly from all nodes.  ``seed`` fully
    determines the stream *and* its hot set — the CLI path passes
    ``hyperparam.seed``, so a rerun replays identical traffic."""
    rng = np.random.default_rng(seed)
    hot = rng.choice(num_nodes, size=min(int(hot_set), num_nodes),
                     replace=False)
    out = []
    for _ in range(int(num_requests)):
        if rng.random() < hot_fraction:
            out.append(rng.choice(hot, size=request_size,
                                  replace=request_size > len(hot)))
        else:
            out.append(rng.integers(0, num_nodes, request_size))
    return out


class GSgnnInferenceService:
    """Continuous-batching inference service over one trained model.

    ``submit`` enqueues a request and returns its id; ``step`` sheds
    expired requests and processes one batch (False when idle);
    ``result`` returns a completed request's rows.
    ``serve`` is the batch-offline convenience: submit a whole stream,
    drain, return every response.

    ``cache_slots: 0`` disables the cache (every batch computes —
    cold-path behavior, and the parity reference).  Batches run through
    the inferer's ``device_infer_program(batch_size)``.
    """

    def __init__(self, trainer, batch_size: int, cache_slots: int = 4096,
                 max_staleness_steps: int = 64, clock=time.perf_counter):
        self.program = trainer.device_infer_program(batch_size)
        self.ntype = self.program.ntype
        self.batch_size = self.program.batch_size
        self.cache = DeviceEmbeddingCache(cache_slots, max_staleness_steps) \
            if cache_slots > 0 else None
        self.batcher = ContinuousBatcher(self.batch_size)
        self.clock = clock
        self.latency = LatencyRing()
        self._step_no = 0            # program step counter (staleness age)
        self._next_rid = 0
        self._requests: Dict[int, ServeRequest] = {}
        self.counters = {k: 0 for k in (
            "requests", "rows_served", "compute_batches", "computed_rows",
            "padding_rows", "warm_rows", "dedup_rows", "cold_misses",
            "stale_refreshes", "shed_rows", "requests_served",
            "requests_expired", "prefetch_dispatches")}

    # ------------------------------------------------------------------
    def submit(self, seeds, priority: str = "high",
               deadline: Optional[float] = None) -> int:
        """Enqueue a request.  ``deadline`` is an absolute ``clock``
        value (None = never sheds)."""
        if priority not in _PRIORITY_ORDER:
            raise ValueError(f"unknown priority {priority!r}; known: "
                             f"{list(_PRIORITY_ORDER)}")
        rank = _PRIORITY_ORDER.index(priority)
        seeds = np.asarray(seeds, np.int64).reshape(-1)
        rid = self._next_rid
        self._next_rid += 1
        req = ServeRequest(rid=rid, seeds=seeds, t_submit=self.clock(),
                           priority=priority, rank=rank, deadline=deadline)
        self._requests[rid] = req
        self.batcher.add(req)
        self.counters["requests"] += 1
        return rid

    # ------------------------------------------------------------------
    def _shed_expired(self, now_t: float) -> int:
        """Drop queued rows of deadline-expired requests and mark the
        requests expired."""
        if not len(self.batcher):
            return 0
        shed = self.batcher.shed(lambda r: r.expired(now_t))
        if not shed:
            return 0
        for req, _, _ in shed:
            if req.status == "pending":
                req.status = "expired"
                req.t_done = now_t
                self.counters["requests_expired"] += 1
        self.counters["shed_rows"] += len(shed)
        return len(shed)

    def step(self) -> bool:
        """Shed expired requests, then serve one batch off the queue;
        False when nothing was done (idle)."""
        shed = self._shed_expired(self.clock())
        if not len(self.batcher):
            return shed > 0
        now = self._step_no
        cache = self.cache
        is_cached = (lambda s: cache.fresh(s, now)) if cache is not None \
            else (lambda s: False)
        items, compute_ids = self.batcher.next_batch(is_cached)

        pos: Dict[int, int] = {}
        emb_c = out_c = None
        if compute_ids:
            if cache is not None:
                for s in compute_ids:
                    key = "stale_refreshes" if s in cache else "cold_misses"
                    self.counters[key] += 1
            padded, _ = pad_seeds(np.asarray(compute_ids, np.int64),
                                  self.batch_size)
            emb_d, out_d = self.program(padded)
            self._step_no += 1
            self.counters["compute_batches"] += 1
            self.counters["computed_rows"] += len(compute_ids)
            self.counters["padding_rows"] += \
                self.batch_size - len(compute_ids)
            emb_c, out_c = emb_d.cpu().numpy(), out_d.cpu().numpy()
            pos = {s: i for i, s in enumerate(compute_ids)}

        # Gather warm rows BEFORE inserting the compute batch: under
        # cache pressure the insert may evict entries the batcher
        # classified warm for this very step.
        warm = self._gather_warm(items, pos, now)
        if compute_ids and cache is not None:
            cache.insert(compute_ids, (emb_d, out_d), now)
        # Prefetch: with rows still queued, peek at the batch the next
        # step will compute and dispatch its program call now — the
        # device works on batch k+1 while this batch's rows transfer to
        # host and resolve below (insert above already happened, so the
        # peek sees the same cache state next_batch will).
        self._prefetch_next()
        # row accounting (partition of the batch's served rows):
        #   computed_rows — unique seeds the program computed,
        #   dedup_rows   — extra rows that shared a compute slot,
        #   warm_rows    — rows resolved from the cache.
        n_compute_side = sum(1 for _, _, s in items if s in pos)
        self.counters["warm_rows"] += len(items) - n_compute_side
        self.counters["dedup_rows"] += n_compute_side - len(pos)

        for req, row, s in items:
            if s in pos:
                req.resolve(row, (emb_c[pos[s]], out_c[pos[s]]))
            else:
                req.resolve(row, warm[s])
            if req.remaining == 0 and req.t_done is None:
                req.t_done = self.clock()
                req.status = "done"
                self.counters["requests_served"] += 1
                self.latency.record(req.t_done - req.t_submit, req.t_done)
        self.counters["rows_served"] += len(items)
        return True

    def _prefetch_next(self):
        """Issue the next queued batch's program call ahead of time
        (no-op when idle or when every queued seed is warm)."""
        if not len(self.batcher):
            return
        nxt = self._step_no
        cache = self.cache
        is_cached = (lambda s: cache.fresh(s, nxt)) if cache is not None \
            else (lambda s: False)
        nxt_ids = self.batcher.peek_compute_ids(is_cached)
        if not nxt_ids:
            return
        padded, _ = pad_seeds(np.asarray(nxt_ids, np.int64),
                              self.batch_size)
        self.program.prefetch(padded)
        self.counters["prefetch_dispatches"] += 1

    def _gather_warm(self, items, pos, now) -> Dict[int, tuple]:
        """Host rows for the batch's cache-resolved seeds: unique warm
        ids -> slots -> chunked fixed-shape device gathers."""
        warm_ids, seen = [], set()
        for _, _, s in items:
            if s not in pos and s not in seen:
                seen.add(s)
                warm_ids.append(s)
        out: Dict[int, tuple] = {}
        if not warm_ids:
            return out
        slots, _ = self.cache.lookup(np.asarray(warm_ids), now)
        if (slots < 0).any():
            raise RuntimeError(
                "cache entry vanished between batching and resolution — "
                "the batcher and cache must share one step clock")
        B = self.batch_size
        for start in range(0, len(warm_ids), B):
            chunk = slots[start:start + B]
            sl = np.zeros(B, np.int64)
            sl[:len(chunk)] = chunk
            rows = tuple(r.cpu().numpy() for r in self.cache.gather(sl))
            for j, s in enumerate(warm_ids[start:start + len(chunk)]):
                out[s] = tuple(r[j] for r in rows)
        return out

    def drain(self):
        while self.step():
            pass

    # ------------------------------------------------------------------
    def result(self, rid: int) -> Optional[dict]:
        """The completed response for ``rid``: row ``i`` answers seed
        ``seeds[i]`` (duplicates included — padding and dedup never leak
        into the row count).  None while still in flight; an expired
        request answers with ``status: "expired"`` and no rows."""
        req = self._requests.get(rid)
        if req is None or req.status == "pending":
            return None
        if req.status == "expired":
            return {"rid": rid, "status": "expired",
                    "seeds": req.seeds.copy(),
                    "latency_s": req.t_done - req.t_submit}
        return {"rid": rid, "status": "done", "seeds": req.seeds.copy(),
                "emb": np.stack([p[0] for p in req.rows]),
                "out": np.stack([p[1] for p in req.rows]),
                "latency_s": req.t_done - req.t_submit,
                "t_done": req.t_done}

    def serve(self, seed_lists, priority: str = "high") -> List[dict]:
        """Submit a whole stream, drain it, return responses in order."""
        rids = [self.submit(s, priority=priority) for s in seed_lists]
        self.drain()
        return [self.result(r) for r in rids]

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        out = dict(self.counters)
        rows = max(self.counters["rows_served"], 1)
        out["hit_rate"] = self.counters["warm_rows"] / rows
        out.update(self.latency.summary())
        if self.cache is not None:
            out["cache"] = self.cache.stats()
        return out
