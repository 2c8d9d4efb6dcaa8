"""pack_host_ms.serve: median ms of the program's ``serve.pack`` span
(``QGPipeline._pack``: numpy packing of the fixed-shape host batch) over
the traced generate() calls."""

from portbench import spans


def read(ctx):
    return spans.median_ms(ctx, "serve.pack")
