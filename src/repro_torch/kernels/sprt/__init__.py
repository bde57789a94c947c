from repro_torch.kernels.sprt.ops import sprt_scan
from repro_torch.kernels.sprt.ref import sprt_chunked_ref, sprt_ref
from repro_torch.kernels.sprt.sprt import sprt_cuda

__all__ = ["sprt_scan", "sprt_chunked_ref", "sprt_ref", "sprt_cuda"]
