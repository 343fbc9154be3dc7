"""Device-resident node-feature tables.

The full per-ntype feature tables are placed on the device once, and a
batch gathers ``table[frontier_ids]`` on the device, so only seed ids
cross from the host.  Tables are inference inputs, not parameters.
"""
from __future__ import annotations

from typing import Dict

import torch


class DeviceFeatureStore:
    """Per-ntype device feature tables."""

    def __init__(self, graph, device: torch.device,
                 feat_field: str = "feat"):
        self.feat_field = feat_field
        self.tables: Dict[str, torch.Tensor] = {}
        for nt in graph.ntypes:
            f = graph.node_feats.get(nt, {}).get(feat_field)
            if f is not None:
                self.tables[nt] = torch.from_numpy(f).to(device)

    def __contains__(self, ntype: str) -> bool:
        return ntype in self.tables

    def gather(self, ntype: str, ids: torch.Tensor) -> torch.Tensor:
        """Rows ``ids`` of ``ntype``'s table; ids must be valid rows."""
        return self.tables[ntype].index_select(0, ids)
