"""swin3d_mfu.serve: model FLOPs the traced generate() calls' requests
need at their real lengths with the Video Swin Transformer as the video
encoder (``arith_swin3d.request_flops``: the trunk over each clip's own
ceil(n / 2) x 56 x 56 tokens, the decoder attending over its ceil(n / 2)
memory steps; text, audio and the decoder as ``mfu.serve`` counts them),
over the traced window, per cent of the H100's bf16 peak (989
TFLOP/s)."""

from portbench import arith, arith_swin3d


def read(ctx):
    tr, calls, cfg = ctx.get("trace"), ctx.get("calls"), ctx["cfg"]
    if tr is None or not calls:
        return None
    flops = sum(arith_swin3d.request_flops(cfg, max(1, t), f, e, s)
                for c in calls for t, f, e, s in zip(
                    c["text"], c["frames"], c["examples"], c["steps"]))
    return 100.0 * flops / tr.window_s / arith.PEAK["bf16"]
