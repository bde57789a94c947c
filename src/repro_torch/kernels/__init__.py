# The two places where the JAX package drops to a Pallas TPU kernel, each a
# hand-written CUDA kernel for Hopper here: the MSET2 similarity operator (the
# paper's named CUDA kernel, Fig. 3) and flash attention (the LM serving path).
# Beside them, the port's own kernels: the SPRT recursion, which the JAX package
# compiles as one lax.scan, and the float32 products W = Ginv K and X_hat = W^T D on
# the tensor cores, which it leaves to XLA's dot.
from repro_torch.kernels.attention import flash_attention_cuda, gqa_attention, mha_ref
from repro_torch.kernels.gemm import gemm, gemm_cuda, gemm_ref
from repro_torch.kernels.similarity import similarity, similarity_cuda, similarity_ref
from repro_torch.kernels.sprt import sprt_chunked_ref, sprt_cuda, sprt_ref, sprt_scan

__all__ = [
    "flash_attention_cuda",
    "gemm",
    "gemm_cuda",
    "gemm_ref",
    "gqa_attention",
    "mha_ref",
    "similarity",
    "similarity_cuda",
    "similarity_ref",
    "sprt_chunked_ref",
    "sprt_cuda",
    "sprt_ref",
    "sprt_scan",
]
