"""Public entry of ``nbr_sample``: draw ``fanout`` in-neighbors per dst
id from a device CSR.

The random stream is counter-based: callers derive a key per (step,
layer, edge block) with ``core.prng.fold_in``, the entry turns it into
one uniform 32-bit word per (dst, fanout) slot, and the kernel maps the
words onto CSR segments.  CUDA tensors launch the CUDA kernel
(``csrc/nbr_sample.cu``); CPU tensors take the plain version in
``ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.kernels.build import CudaKernel, check_tensor
from repro_torch.kernels.nbr_sample.ref import nbr_sample_ref

KERNEL = CudaKernel("nbr_sample.cu", "nbr_sample_launch",
                    ["ptr"] * 8 + ["i64"] * 3)


def segment_bounds(row_ptr, dst_ids):
    """CSR segment (starts, degs) of each dst id, as int32."""
    ids = dst_ids.to(torch.int64)
    starts = row_ptr[ids]
    return starts, row_ptr[ids + 1] - starts


def nbr_sample_cuda(bits, starts, degs, col_idx, edge_id):
    """Launch the CUDA kernel; same contract as ``nbr_sample_ref``."""
    dev = bits.device
    if dev.type != "cuda":
        raise ValueError(f"nbr_sample_cuda needs CUDA tensors, got {dev}")
    check_tensor("bits", bits, torch.int32, 2, dev)
    n, f = bits.shape
    for name, t in (("starts", starts), ("degs", degs)):
        check_tensor(name, t, torch.int32, 1, dev)
        if t.shape[0] != n:
            raise ValueError(f"{name} has {t.shape[0]} rows, bits has {n}")
    for name, t in (("col_idx", col_idx), ("edge_id", edge_id)):
        check_tensor(name, t, torch.int32, 1, dev)
    num_entries = col_idx.shape[0]
    if num_entries == 0 or edge_id.shape[0] != num_entries:
        raise ValueError("col_idx/edge_id must be non-empty and of equal "
                         "length (DeviceCSR pads them)")
    nbr = torch.empty((n, f), dtype=torch.int32, device=dev)
    eid = torch.empty((n, f), dtype=torch.int32, device=dev)
    mask = torch.empty((n, f), dtype=torch.bool, device=dev)
    KERNEL.launch(dev, bits.data_ptr(), starts.data_ptr(), degs.data_ptr(),
                  col_idx.data_ptr(), edge_id.data_ptr(), nbr.data_ptr(),
                  eid.data_ptr(), mask.data_ptr(), n, f, num_entries)
    return nbr, eid, mask


def nbr_sample(row_ptr, col_idx, edge_id, dst_ids, key=None, *,
               fanout: int, bits=None):
    """row_ptr: (num_dst+1,) int32; col_idx/edge_id: (E,) int32 padded
    tables; dst_ids: (n,) int; key: a ``core.prng`` key ->
    (nbr (n, fanout) int32, eid (n, fanout) int32, mask (n, fanout) bool).
    Rows with degree 0 are fully masked.

    ``bits`` overrides the uniform words (an (n, fanout) int32 tensor of
    uint32 bit patterns), e.g. the seed-keyed words of serving."""
    starts, degs = segment_bounds(row_ptr, dst_ids)
    if bits is None:
        bits = prng.bits(key, (dst_ids.shape[0], fanout),
                         device=dst_ids.device)
    if bits.device.type == "cuda":
        return nbr_sample_cuda(bits, starts, degs, col_idx, edge_id)
    if bits.device.type == "cpu":
        return nbr_sample_ref(bits, starts, degs, col_idx, edge_id)
    raise ValueError(f"nbr_sample: unsupported device {bits.device}")
