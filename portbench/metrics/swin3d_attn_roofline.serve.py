"""swin3d_attn_roofline.serve: the Video Swin trunk's window attention
against its roofline: the bound time of its work
(``arith_swin3d.attention_launches`` at each traced call's real clip
lengths and frames bucket: for every block and every window holding a
live token, 2 x 392^2 x C multiply-adds at the bf16 peak, or q, k, v and
the output of those windows in bf16 and the block's bias table once each
at 3.35 TB/s, whichever is larger) over the device time of the kernels
that compute it, per cent. The same work is held to the same bound
whatever implements it; fully padded windows count as no work.

The kernels: PyTorch's fused attention (cuDNN's
``cudnn_generated_fort_native_sdpa...`` with its ``Memset``; the
memory-efficient ``fmha_cutlassF...AttentionKernel`` or ``flash_fwd``
should another be chosen), and, since the program builds each call's
masks, the kernels that build them and feed its second pass: the bias
table's and the mixed rows' gathers (``index_elementwise_kernel``), the
bf16 broadcast adds of bias, shift mask and padded keys
(``CUDAFunctor_add<c10::BFloat16>``, which nothing else of the cell
launches) and the second pass's ``index_copy``. A memset elsewhere in the
traced window can only lower the reading."""

from portbench import arith_swin3d
from portbench.readers import roofline_pct

KERNELS = (r"cudnn.*sdpa", r"^Memset", r"fmha_cutlass", r"AttentionKernel",
           r"flash_fwd", r"\bindex_elementwise_kernel", r"index_copy",
           r"CUDAFunctor_add<c10::BFloat16>")


def launches(cfg, call):
    return arith_swin3d.attention_launches(call["frames"], call["fcap"],
                                           cfg["frame_size"])


def read(ctx):
    return roofline_pct(ctx, KERNELS, launches, "bf16")
