from repro_torch.kernels.gemm.gemm import gemm_cuda, split_cols, split_rows
from repro_torch.kernels.gemm.ops import gemm
from repro_torch.kernels.gemm.ref import gemm_ref

__all__ = ["gemm", "gemm_cuda", "gemm_ref", "split_cols", "split_rows"]
