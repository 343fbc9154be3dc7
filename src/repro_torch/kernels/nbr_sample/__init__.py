from repro_torch.kernels.nbr_sample.ops import (nbr_sample, nbr_sample_cuda,
                                                segment_bounds)
from repro_torch.kernels.nbr_sample.ref import nbr_sample_ref

__all__ = ["nbr_sample", "nbr_sample_cuda", "nbr_sample_ref",
           "segment_bounds"]
