"""encode_ms.serve: median host ms of ``decode.encode`` (the text, video
and audio encoders) for one pool batch on the card, synchronised."""

from portbench.readers import span_median_ms


def read(ctx):
    return span_median_ms(ctx, "encode")
