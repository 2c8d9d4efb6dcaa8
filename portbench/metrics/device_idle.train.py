"""device_idle.train: per cent of a traced stretch of ``run_epoch`` in
which no kernel or copy ran on the card."""

from portbench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
