"""readback_ms.serve: median ms of the program's ``serve.readback`` span
(the finalizer ``generate_async`` returns: the wait for the tokens and
their words) over the traced generate() calls."""

from portbench import spans


def read(ctx):
    return spans.median_ms(ctx, "serve.readback")
