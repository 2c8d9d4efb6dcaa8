"""encode_idle_ms.serve: median ms, over the traced generate() calls, in
which the card ran nothing while the program's ``model.encode`` span was
open (``decode.encode`` enqueueing the encoders)."""

from portbench import spans


def read(ctx):
    return spans.idle_median_ms(ctx, "model.encode")
