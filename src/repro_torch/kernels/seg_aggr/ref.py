"""Plain PyTorch version of the ``gather_seg_aggr`` kernel."""
from __future__ import annotations

import torch

REDUCES = ("sum", "mean", "max")


def gather_seg_aggr_ref(table, idx, mask, reduce: str = "mean"):
    """Row gather + masked fanout reduction.

    table: (N, d) frontier rows; idx: (n, f) int row indices into table;
    mask: (n, f) bool validity -> (n, d).  Equivalent to reducing
    ``table[idx]`` over the fanout axis under ``mask``; fully-masked
    rows produce 0 in every reduce mode.  The CPU path of
    ``ops.gather_seg_aggr`` and the yardstick the CUDA kernel is checked
    against.
    """
    if reduce not in REDUCES:
        raise ValueError(f"reduce must be one of {REDUCES}, got {reduce!r}")
    rows = table[idx.to(torch.int64)]                  # (n, f, d)
    if reduce == "max":
        s = rows.masked_fill(~mask[..., None], float("-inf")).amax(dim=1)
        return torch.where(mask.any(dim=1, keepdim=True), s,
                           torch.zeros_like(s))
    m = mask.to(table.dtype)
    s = (rows * m[..., None]).sum(dim=1)
    if reduce == "mean":
        s = s / m.sum(dim=1).clamp(min=1.0)[:, None]
    return s
