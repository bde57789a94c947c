from repro_torch.kernels.attention.flash import flash_attention_cuda
from repro_torch.kernels.attention.ops import gqa_attention
from repro_torch.kernels.attention.ref import mha_ref

__all__ = ["flash_attention_cuda", "gqa_attention", "mha_ref"]
