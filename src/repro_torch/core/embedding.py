"""Embedding tables for featureless node types.

In this port a table is read-only (serving): rows are looked up, never
updated.  The adagrad accumulator ``gsum`` that training keeps beside
the table is carried along so checkpoints round-trip unchanged.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


class SparseEmbedding:
    """(num_nodes, dim) table of a featureless ntype."""

    def __init__(self, num_nodes: int, dim: int, device: torch.device, *,
                 name: str = "emb",
                 generator: Optional[torch.Generator] = None):
        self.num_nodes = int(num_nodes)
        self.dim = int(dim)
        self.name = name
        table = torch.randn((num_nodes, dim), generator=generator) * 0.1
        self.table = table.to(device)
        self.gsum = torch.zeros(num_nodes, device=device)

    def lookup(self, ids: torch.Tensor) -> torch.Tensor:
        """Rows ``ids``; ids must be valid rows."""
        return self.table.index_select(0, ids)

    def load_state_dict(self, st):
        table, gsum = np.asarray(st["table"]), np.asarray(st["gsum"])
        if table.shape != (self.num_nodes, self.dim) or \
                gsum.shape != (self.num_nodes,):
            raise ValueError(
                f"embedding {self.name!r}: checkpoint table "
                f"{table.shape} / gsum {gsum.shape} do not match "
                f"({self.num_nodes}, {self.dim})")
        self.table = torch.from_numpy(table.astype(np.float32)).to(
            self.table.device)
        self.gsum = torch.from_numpy(gsum.astype(np.float32)).to(
            self.gsum.device)
