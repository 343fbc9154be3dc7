"""Static block schema: the shapes/offsets side of an MFG mini-batch
(the port's copy of ``repro.gnn.schema``).

A ``BlockSchema`` is fully determined by (seed counts, fanouts, graph
etypes); the GNN apply reads its offsets while the masks flow through
as tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.sampling import SamplePlan


@dataclasses.dataclass(frozen=True)
class EdgeMeta:
    ekey: str            # "src___rel___dst"
    src_t: str
    rel: str
    dst_t: str
    num_dst: int
    fanout: int
    src_offset: int


@dataclasses.dataclass(frozen=True)
class LayerSchema:
    edges: Tuple[EdgeMeta, ...]
    dst_counts: Tuple[Tuple[str, int], ...]
    src_counts: Tuple[Tuple[str, int], ...]
    self_offsets: Tuple[Tuple[str, int], ...]

    def dst_count(self, nt: str) -> int:
        return dict(self.dst_counts)[nt]

    def self_offset(self, nt: str) -> Optional[int]:
        return dict(self.self_offsets).get(nt)


@dataclasses.dataclass(frozen=True)
class BlockSchema:
    layers: Tuple[LayerSchema, ...]

    @property
    def num_layers(self) -> int:
        return len(self.layers)


def ekey(etype) -> str:
    return "___".join(etype)


def schema_of_plan(plan: SamplePlan) -> BlockSchema:
    """The BlockSchema a device ``SamplePlan`` lays out."""
    layers = []
    for pl_layer in plan.layers:
        edges = tuple(
            EdgeMeta(ekey=ekey(pe.etype), src_t=pe.etype[0],
                     rel=pe.etype[1], dst_t=pe.etype[2], num_dst=pe.num_dst,
                     fanout=pe.fanout, src_offset=pe.src_offset)
            for pe in pl_layer.edges)
        layers.append(LayerSchema(
            edges=edges,
            dst_counts=pl_layer.dst_counts,
            src_counts=pl_layer.src_counts,
            self_offsets=pl_layer.self_offsets,
        ))
    return BlockSchema(layers=tuple(layers))
