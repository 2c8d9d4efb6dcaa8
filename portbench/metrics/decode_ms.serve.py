"""decode_ms.serve: median host ms of ``decode.decode_from_memories`` (the
greedy decoder loop) for one pool batch, synchronised."""

from portbench.readers import span_median_ms


def read(ctx):
    return span_median_ms(ctx, "decode")
