"""device_idle.serve: per cent of the traced stretch of generate() calls
in which no kernel or copy ran on the card."""

from portbench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
