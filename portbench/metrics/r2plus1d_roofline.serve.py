"""r2plus1d_roofline.serve: the R(2+1)D-18 trunk's conv launches against
their roofline: the launches' bound time (``arith_r2plus1d
.trunk_launches`` at each traced call's rows and frames bucket: the
operations at the bf16 peak or the bf16 input, weight and output bytes at
3.35 TB/s, whichever is larger) over the device time of the cuDNN kernels
that run them, per cent. On an H100 those are
``sm90_xmma_fprop_implicit_gemm_bf16...`` and ``sm80_xmma_fprop_...`` for
the convs whose channels are multiples of 8, the f32 fallback
``sm80_xmma_fprop_implicit_gemm_indexed_f32f32...`` with cuDNN's layout
and dtype transforms (``nhwcToNchwKernel``, ``nchwToNhwcKernel``) around
it for the rest, and ``nhwcAddPaddingKernel``; ``convolve`` and ``fprop``
cover cuDNN's other conv kernels should its heuristics pick one. The same
work is held to the same bf16 bound whatever kernel runs it. VGGish's
conv1, the one other cuDNN conv of a call (~0.2 ms), is counted too,
which can only lower the reading."""

from portbench import arith_r2plus1d
from portbench.readers import roofline_pct

KERNELS = (r"fprop", r"convolve", r"\bnhwcToNchwKernel<",
           r"\bnchwToNhwcKernel<", r"\bnhwcAddPaddingKernel<")


def launches(cfg, call):
    return arith_r2plus1d.trunk_launches(call["rows"], call["fcap"],
                                         cfg["frame_size"])


def read(ctx):
    return roofline_pct(ctx, KERNELS, launches, "bf16")
