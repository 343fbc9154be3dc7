"""Public entry of ``gather_seg_aggr``: fused ``table[idx]`` gather +
masked fanout reduce, (N, d) x (n, f) -> (n, d), without the (n, f, d)
intermediate.  CUDA tensors launch the CUDA kernel
(``csrc/gather_seg_aggr.cu``); CPU tensors take the plain version in
``ref.py``.  Forward only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import CudaKernel, check_tensor
from repro_torch.kernels.seg_aggr.ref import REDUCES, gather_seg_aggr_ref

KERNEL = CudaKernel("gather_seg_aggr.cu", "gather_seg_aggr_launch",
                    ["ptr"] * 4 + ["i64"] * 5)


def gather_seg_aggr_cuda(table, idx, mask, reduce: str = "mean"):
    """Launch the CUDA kernel; same contract as ``gather_seg_aggr_ref``
    for a float32 table."""
    if reduce not in REDUCES:
        raise ValueError(f"reduce must be one of {REDUCES}, got {reduce!r}")
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"gather_seg_aggr_cuda needs CUDA tensors, got "
                         f"{dev}")
    for name, t, dtype in (("table", table, torch.float32),
                           ("idx", idx, torch.int32),
                           ("mask", mask, torch.bool)):
        check_tensor(name, t, dtype, 2, dev)
    if mask.shape != idx.shape:
        raise ValueError(f"mask {tuple(mask.shape)} and idx "
                         f"{tuple(idx.shape)} differ")
    n, f = idx.shape
    d = table.shape[1]
    out = torch.empty((n, d), dtype=torch.float32, device=dev)
    vec4 = d % 4 == 0 and table.data_ptr() % 16 == 0
    KERNEL.launch(dev, table.data_ptr(), idx.data_ptr(), mask.data_ptr(),
                  out.data_ptr(), n, f, d, REDUCES.index(reduce), int(vec4))
    return out


def gather_seg_aggr(table, idx, mask, reduce: str = "mean"):
    """table: (N, d) float32 frontier rows; idx: (n, f) int32 row indices;
    mask: (n, f) bool -> (n, d)."""
    if table.device.type == "cuda":
        return gather_seg_aggr_cuda(table, idx, mask, reduce)
    if table.device.type == "cpu":
        return gather_seg_aggr_ref(table, idx, mask, reduce)
    raise ValueError(f"gather_seg_aggr: unsupported device {table.device}")
