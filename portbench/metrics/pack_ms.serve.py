"""pack_ms.serve: median host ms of ``QGPipeline._pack`` and
``_to_device`` for one pool batch, ending in a synchronise (request
packing and H2D)."""

from portbench.readers import span_median_ms


def read(ctx):
    return span_median_ms(ctx, "pack")
