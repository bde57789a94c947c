from repro_torch.kernels.similarity.ops import similarity
from repro_torch.kernels.similarity.ref import similarity_ref
from repro_torch.kernels.similarity.similarity import similarity_cuda

__all__ = ["similarity", "similarity_ref", "similarity_cuda"]
