"""Neighbor aggregation over padded fixed-fanout blocks.

The sampler lays an edge block's draws out contiguously in the source
frontier, so aggregation is the fused ``gather_seg_aggr`` kernel over an
iota index block.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.seg_aggr import gather_seg_aggr


def fanout_indices(offset: int, num_dst: int, fanout: int,
                   device: torch.device) -> torch.Tensor:
    """Row indices of an edge block's sampled neighbors in the frontier:
    a reshaped iota starting at ``offset``."""
    idx = torch.arange(offset, offset + num_dst * fanout, dtype=torch.int32,
                       device=device)
    return idx.reshape(num_dst, fanout)


def gather_masked_agg(table, idx, mask, reduce: str = "mean"):
    """Fused ``table[idx]`` gather + masked fanout reduce: (N, d) x (n, f)
    -> (n, d) without materializing the (n, f, d) intermediate."""
    return gather_seg_aggr(table, idx, mask, reduce)
