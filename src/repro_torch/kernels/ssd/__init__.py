from repro_torch.kernels.ssd.ops import SSDIntra, ssd_chunked
from repro_torch.kernels.ssd.ref import (ssd_intra_bwd_ref, ssd_intra_ref,
                                         ssd_ref, ssd_step_ref)
from repro_torch.kernels.ssd.ssd import (ssd_cuda, ssd_intra_bwd_cuda,
                                         ssd_intra_cuda)

__all__ = ["SSDIntra", "ssd_chunked", "ssd_cuda", "ssd_intra_bwd_cuda",
           "ssd_intra_bwd_ref", "ssd_intra_cuda", "ssd_intra_ref",
           "ssd_ref", "ssd_step_ref"]
