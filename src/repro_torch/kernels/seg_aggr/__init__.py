from repro_torch.kernels.seg_aggr.ops import (gather_seg_aggr,
                                              gather_seg_aggr_cuda)
from repro_torch.kernels.seg_aggr.ref import gather_seg_aggr_ref

__all__ = ["gather_seg_aggr", "gather_seg_aggr_cuda", "gather_seg_aggr_ref"]
