"""step_ms.train: median host ms of one train step on the card (the
Trainer's ``caps_for``, H2D, ``train_step`` and the loss read), each
ending in a synchronise."""

from portbench.readers import span_median_ms


def read(ctx):
    return span_median_ms(ctx, "step")
