"""Device-resident fixed-slot LRU cache for served embeddings.

A warm request skips the GNN program and resolves via one device gather
from a fixed ``(capacity, ...)`` table.  Slot bookkeeping (id -> slot,
LRU ticks, insert-step ages) is host-side numpy; only the row payloads
live on the device.

Inserts and gathers both move exactly ``batch`` rows (the serve batch
size).  Padding rows carry the out-of-range slot ``capacity``: an insert
drops them and a gather clips them to a valid slot.  Both are written
out on the host before indexing, because a torch index must be in range
(on CUDA an out-of-range index is a device-side assert).  Staleness is
measured in *program steps*: an entry inserted at compute-step ``s`` is
fresh while ``now - s <= max_staleness_steps``; a stale entry is a miss,
recomputed by the full program and re-inserted in place.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


class DeviceEmbeddingCache:
    """Fixed-slot LRU over device row tables, keyed by global node id.

    ``insert`` receives the compute batch's device tensors directly (no
    host round-trip of the payload); ``gather`` returns device rows for
    a padded slot vector.  One table per served array (embeddings +
    logits), allocated lazily from the first insert's shapes/dtypes.
    """

    def __init__(self, capacity: int, max_staleness_steps: int = 64):
        if capacity <= 0:
            raise ValueError("cache capacity must be positive "
                             "(use cache_slots: 0 to disable the cache)")
        self.capacity = int(capacity)
        self.max_staleness = int(max_staleness_steps)
        self._slot_of = {}                                  # id -> slot
        self._ids = np.full(self.capacity, -1, np.int64)    # slot -> id
        self._step = np.zeros(self.capacity, np.int64)      # insert step
        self._used = np.zeros(self.capacity, np.int64)      # LRU tick
        self._free = list(range(self.capacity - 1, -1, -1))
        self._tick = 0
        self._tables: Optional[Tuple[torch.Tensor, ...]] = None
        self.hits = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._slot_of)

    def __contains__(self, nid) -> bool:
        return int(nid) in self._slot_of

    # ------------------------------------------------------------------
    def fresh(self, nid, now_step: int) -> bool:
        """Pure staleness check (no LRU touch, no counters) — the
        batcher's classifier; must agree with ``lookup`` at the same
        ``now_step``."""
        s = self._slot_of.get(int(nid))
        return s is not None and now_step - self._step[s] <= \
            self.max_staleness

    def lookup(self, ids, now_step: int):
        """Resolve ids -> slots; a miss or stale entry yields slot -1
        (stale also sets the second returned mask).  Hits bump the LRU
        tick and the hit counter."""
        ids = np.asarray(ids, np.int64)
        slots = np.full(len(ids), -1, np.int64)
        stale = np.zeros(len(ids), bool)
        for i, nid in enumerate(ids):
            s = self._slot_of.get(int(nid))
            if s is None:
                continue
            if now_step - self._step[s] > self.max_staleness:
                stale[i] = True
                continue
            slots[i] = s
            self._tick += 1
            self._used[s] = self._tick
            self.hits += 1
        return slots, stale

    # ------------------------------------------------------------------
    def _alloc(self) -> int:
        if self._free:
            return self._free.pop()
        s = int(np.argmin(self._used))       # least recently used slot
        del self._slot_of[int(self._ids[s])]
        self.evictions += 1
        return s

    def insert(self, ids, rows: Tuple[torch.Tensor, ...], now_step: int):
        """Cache ``rows[j][:len(ids)]`` under ``ids`` (an already-present
        id refreshes in place; new ids evict LRU under pressure).

        ``rows`` is a tuple of device tensors of one shape
        ``(batch, ...)`` each — the compute batch's padded outputs; rows
        past ``len(ids)`` are padding and are dropped.  At most
        ``capacity`` ids are kept (the rest are ignored, so one oversized
        batch cannot evict its own rows)."""
        ids = np.asarray(ids, np.int64)[:self.capacity]
        batch = int(rows[0].shape[0])
        slots = np.full(batch, self.capacity, np.int64)
        for i, nid in enumerate(ids):
            nid = int(nid)
            s = self._slot_of.get(nid)
            if s is None:
                s = self._alloc()
                self._slot_of[nid] = s
                self._ids[s] = nid
            slots[i] = s
            self._step[s] = now_step
            self._tick += 1
            self._used[s] = self._tick
        if self._tables is None:
            self._tables = tuple(
                torch.zeros((self.capacity,) + tuple(r.shape[1:]),
                            dtype=r.dtype, device=r.device)
                for r in rows)
        # drop the padding rows: keep only in-range slots
        keep = np.nonzero(slots < self.capacity)[0]
        dev = self._tables[0].device
        src = torch.from_numpy(keep).to(dev)
        dst = torch.from_numpy(slots[keep]).to(dev)
        for t, r in zip(self._tables, rows):
            t[dst] = r.index_select(0, src).to(t.dtype)

    def gather(self, slots):
        """Device rows for a padded ``(batch,)`` slot vector (invalid /
        padding slots clip to a valid slot — callers mask by position)."""
        sl = np.clip(np.asarray(slots, np.int64), 0, self.capacity - 1)
        idx = torch.from_numpy(sl).to(self._tables[0].device)
        return tuple(t.index_select(0, idx) for t in self._tables)

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        return {"capacity": self.capacity, "entries": len(self),
                "hits": self.hits, "evictions": self.evictions}
