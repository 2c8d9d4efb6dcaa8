"""decode_idle_ms.serve: median ms, over the traced generate() calls, in
which the card ran nothing while the program's ``model.decode`` span was
open (``decode.decode_from_memories``: the host-paced token loop)."""

from portbench import spans


def read(ctx):
    return spans.idle_median_ms(ctx, "model.decode")
