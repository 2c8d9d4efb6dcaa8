"""mfu.train: model FLOPs of the traced steps' samples at their real
lengths, three times the forward's (forward and backward), over the traced
window, as a per cent of the H100's bf16 peak (989 TFLOP/s)."""

from portbench import arith


def read(ctx):
    tr, flops = ctx.get("trace"), ctx.get("train_flops")
    if tr is None or not flops:
        return None
    return 100.0 * flops / tr.window_s / arith.PEAK["bf16"]
