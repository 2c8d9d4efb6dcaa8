"""mfu.serve: model FLOPs the traced generate() calls' requests need at
their real lengths (text tokens, frames, whole audio examples, served
decoder steps), over the traced window, as a per cent of the H100's bf16
peak (989 TFLOP/s)."""

from portbench.readers import mfu_pct


def read(ctx):
    return mfu_pct(ctx)
