"""h2d_ms.serve: median ms of the program's ``serve.h2d`` span
(``QGPipeline._to_device``: the host batch's copies to the card) over the
traced generate() calls."""

from portbench import spans


def read(ctx):
    return spans.median_ms(ctx, "serve.h2d")
