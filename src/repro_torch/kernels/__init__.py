# The MSET2 similarity operator is the paper's named CUDA kernel (Fig. 3); here it is
# a hand-written CUDA kernel for Hopper. Flash attention (the LM side) is not ported yet.
from repro_torch.kernels.similarity import similarity, similarity_cuda, similarity_ref

__all__ = ["similarity", "similarity_cuda", "similarity_ref"]
