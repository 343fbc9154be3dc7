"""Fixed-fanout neighbor sampling against device CSR tables (the port's
copy of the device path of ``repro.core.sampling``).

Every dst node draws exactly ``fanout`` in-neighbors per edge type (with
replacement when deg > 0; masked rows when deg == 0).  A frontier at
layer l-1 is the concatenation, in a fixed order, of

    [dst nodes themselves (self rows)] ++ [per-etype sampled neighbors]

so each block needs only offsets + masks: neighbor *positions* are
implicit and aggregation is a masked reduction over a contiguous
(num_dst, fanout) slab of frontier rows — the ``gather_seg_aggr``
kernel's layout.  The layout is a pure function of (seed counts,
fanouts, etypes): :func:`plan_sample` computes it on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.core import prng
from repro_torch.core.graph import EType, HeteroGraph
from repro_torch.kernels.nbr_sample import nbr_sample

# the per-(layer, edge block) fold-in stride of the sampler's key stream
_LAYER_STRIDE = 131071


@dataclasses.dataclass(frozen=True)
class PlanEdge:
    """Static metadata of one edge block of a planned minibatch."""
    etype: EType
    num_dst: int
    fanout: int
    src_offset: int
    has_delta_t: bool


@dataclasses.dataclass(frozen=True)
class PlanLayer:
    edges: Tuple[PlanEdge, ...]
    dst_counts: Tuple[Tuple[str, int], ...]
    src_counts: Tuple[Tuple[str, int], ...]
    self_offsets: Tuple[Tuple[str, int], ...]
    # frontier build recipe per src ntype, in concatenation order:
    # ("self", ntype) -> the layer's dst rows; ("edge", i) -> edges[i] draws
    parts: Tuple[Tuple[str, Tuple[Tuple[str, int], ...]], ...]


@dataclasses.dataclass(frozen=True)
class SamplePlan:
    """The shapes/offsets side of a device-sampled minibatch, fully
    determined by (seed counts, fanouts, graph etypes).  ``layers[0]``
    consumes raw features."""
    layers: Tuple[PlanLayer, ...]
    seed_counts: Tuple[Tuple[str, int], ...]


def plan_sample(graph: HeteroGraph, fanouts: Sequence,
                seed_counts: Dict[str, int]) -> SamplePlan:
    """Run the sampler's layer loop symbolically (counts only)."""
    L = len(fanouts)
    frontier = {nt: int(c) for nt, c in seed_counts.items()}
    layers: List[PlanLayer] = []
    for layer in range(L - 1, -1, -1):
        fan = fanouts[layer]
        dst_counts = dict(frontier)
        parts: Dict[str, List[Tuple[str, int]]] = \
            {nt: [("self", 0)] for nt in dst_counts}
        part_counts: Dict[str, List[int]] = \
            {nt: [c] for nt, c in dst_counts.items()}
        self_offsets: Dict[str, Optional[int]] = {nt: 0 for nt in dst_counts}
        edges: List[PlanEdge] = []
        for etype in graph.etypes:
            s, r, d = etype
            if d not in dst_counts or dst_counts[d] == 0:
                continue
            f = fan[etype] if isinstance(fan, dict) else int(fan)
            if s not in part_counts:
                part_counts[s] = []
                parts[s] = []
                self_offsets.setdefault(s, None)
            offset = sum(part_counts[s])
            parts[s].append(("edge", len(edges)))
            part_counts[s].append(dst_counts[d] * f)
            edges.append(PlanEdge(
                etype=etype, num_dst=dst_counts[d], fanout=f,
                src_offset=offset, has_delta_t=False))
        src_counts = {nt: sum(cs) for nt, cs in part_counts.items()}
        layers.append(PlanLayer(
            edges=tuple(edges),
            dst_counts=tuple(sorted(dst_counts.items())),
            src_counts=tuple(sorted(src_counts.items())),
            self_offsets=tuple(sorted(
                (nt, off) for nt, off in self_offsets.items()
                if off is not None)),
            parts=tuple(sorted((nt, tuple(p)) for nt, p in parts.items())),
        ))
        frontier = src_counts
    layers.reverse()
    return SamplePlan(layers=tuple(layers),
                      seed_counts=tuple(sorted(
                          (nt, int(c)) for nt, c in seed_counts.items())))


def pad_seeds(ids: np.ndarray, batch_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad a seed array to a static batch size; returns (padded, mask)."""
    n = len(ids)
    if n > batch_size:
        raise ValueError(f"{n} seeds do not fit a batch of {batch_size}")
    out = np.zeros(batch_size, np.int64)
    out[:n] = ids
    mask = np.zeros(batch_size, bool)
    mask[:n] = True
    return out, mask


class DeviceNeighborSampler:
    """Fixed-fanout sampler that draws against device-resident CSR tables
    with the counter-based threefry stream (``core.prng``) and the
    ``nbr_sample`` kernel.

    Tables are placed on ``device`` once; ``sample`` then launches only
    device work for a batch of seed ids."""

    def __init__(self, graph: HeteroGraph, fanouts: Sequence, seed: int = 0,
                 device=None):
        self.g = graph
        self.fanouts = list(fanouts)
        self.seed = int(seed)
        self.device = resolve_device(device)
        self.base_key = prng.PRNGKey(self.seed)
        self.tables = {}
        for et in graph.etypes:
            csr = graph.device_csr(et, self.device)
            self.tables[et] = {"row_ptr": csr.row_ptr,
                               "col_idx": csr.col_idx,
                               "edge_id": csr.edge_id}
        self._plans: Dict[Tuple[Tuple[str, int], ...], SamplePlan] = {}

    # ------------------------------------------------------------------
    def plan_for(self, seed_counts: Dict[str, int]) -> SamplePlan:
        key = tuple(sorted((nt, int(c)) for nt, c in seed_counts.items()))
        if key not in self._plans:
            self._plans[key] = plan_sample(self.g, self.fanouts, dict(key))
        return self._plans[key]

    # ------------------------------------------------------------------
    def sample(self, plan: SamplePlan, seeds, step: int = 0,
               seed_keyed: bool = False, exclude=None, dp=None, shard=None):
        """Draw one minibatch.

        seeds: {ntype: (count,) int tensor on the sampler's device}
        matching ``plan.seed_counts``; step: the step counter folded into
        the positional stream.

        seed_keyed: draw each frontier row's fanout from a key folded
        with the row's *node id* instead of its batch position, and do
        not fold ``step``.  A row's whole sampled subtree (and hence its
        served embedding) is then a pure function of its node id,
        invariant to batch composition, padding and position: the
        serving determinism mode.

        ``exclude`` (edge exclusion), ``dp`` (data-parallel shards) and
        ``shard`` (row-sharded tables) are not ported yet.

        Returns (masks, delta_t, frontier): per-layer {ekey: (n, f)} bool
        masks and (empty) Δt dicts in block order (``[0]`` consumes raw
        features), and the frontier[0] int32 ids per ntype.
        """
        for name, val in (("exclude", exclude), ("dp", dp),
                          ("shard", shard)):
            if val is not None:
                raise NotImplementedError(
                    f"sample({name}=...) is not ported yet")
        frontier = {nt: torch.as_tensor(seeds[nt]).to(self.device,
                                                      torch.int32)
                    for nt, _ in plan.seed_counts}
        layer_masks: List[Dict[str, torch.Tensor]] = []
        # sampling walks top (seeds) -> bottom; plan stores block order
        for li, pl_layer in enumerate(reversed(plan.layers)):
            keys = [prng.fold_in(prng.fold_in(self.base_key,
                                              0 if seed_keyed else step),
                                 li * _LAYER_STRIDE + ei)
                    for ei in range(len(pl_layer.edges))]
            dst_ids = [frontier[pe.etype[2]] for pe in pl_layer.edges]
            bits = (self._seed_keyed_bits(pl_layer, keys, dst_ids)
                    if seed_keyed else [None] * len(keys))
            draws = []
            masks: Dict[str, torch.Tensor] = {}
            for pe, key, ids, b in zip(pl_layer.edges, keys, dst_ids, bits):
                t = self.tables[pe.etype]
                nbr, _, mask = nbr_sample(
                    t["row_ptr"], t["col_idx"], t["edge_id"], ids, key,
                    fanout=pe.fanout, bits=b)
                masks["___".join(pe.etype)] = mask
                draws.append(nbr)
            new_frontier = {}
            for nt, recipe in pl_layer.parts:
                arrs = [frontier[nt] if kind == "self"
                        else draws[idx].reshape(-1)
                        for kind, idx in recipe]
                new_frontier[nt] = (torch.cat(arrs) if len(arrs) > 1
                                    else arrs[0])
            layer_masks.append(masks)
            frontier = new_frontier
        layer_masks.reverse()
        return layer_masks, [{} for _ in layer_masks], frontier

    def _seed_keyed_bits(self, pl_layer: PlanLayer, keys, dst_ids):
        """One key per (edge block, frontier node id), folded for every
        edge block of the layer in one batched threefry pass, then one
        ``fanout`` block of words per row key (``jax.vmap`` of ``bits``
        over the row keys)."""
        if not pl_layer.edges:
            return []
        fanouts = {pe.fanout for pe in pl_layer.edges}
        if len(fanouts) != 1:
            raise NotImplementedError("per-etype fanouts within one layer "
                                      "are not ported yet")
        counts = [pe.num_dst for pe in pl_layer.edges]
        block_keys = torch.tensor(keys, dtype=torch.int64,
                                  device=self.device)
        repeat = torch.tensor(counts, device=self.device)
        row_keys = prng.fold_in(
            torch.repeat_interleave(block_keys, repeat, dim=0,
                                    output_size=sum(counts)),
            torch.cat(dst_ids))
        words = prng.bits(row_keys, (fanouts.pop(),))
        return list(torch.split(words, counts))
