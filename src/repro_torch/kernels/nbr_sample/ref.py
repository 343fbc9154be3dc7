"""Plain PyTorch version of the ``nbr_sample`` kernel.

The segmented random gather: row i owns the CSR segment
``[starts[i], starts[i] + degs[i])`` of ``col_idx``/``edge_id`` and draws
``fanout`` entries with replacement, one per uniform 32-bit word in
``bits``.  The draw is ``bits % max(deg, 1)`` (unsigned), the position is
clamped into the table, and rows with ``deg == 0`` are fully masked
(their gathers are discarded).  The CPU path of ``ops.nbr_sample`` and
the yardstick the CUDA kernel is checked against.
"""
from __future__ import annotations

import torch

from repro_torch.core.prng import MASK


def nbr_sample_ref(bits, starts, degs, col_idx, edge_id):
    """bits: (n, f) int32 holding uint32 words; starts/degs: (n,) int32;
    col_idx/edge_id: (E,) int32 -> (nbr (n,f) int32, eid (n,f) int32,
    mask (n,f) bool)."""
    n, f = bits.shape
    words = bits.to(torch.int64) & MASK
    span = degs.clamp(min=1).to(torch.int64)
    pos = starts.to(torch.int64)[:, None] + words % span[:, None]
    pos = pos.clamp(0, col_idx.shape[0] - 1)
    nbr = col_idx[pos]
    eid = edge_id[pos]
    mask = (degs > 0)[:, None].expand(n, f).contiguous()
    return nbr, eid, mask
