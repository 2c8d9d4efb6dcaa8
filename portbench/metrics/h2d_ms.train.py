"""h2d_ms.train: median ms of the program's ``train.h2d`` span
(``train.to_device``: the step's copies to the card) over the traced
steps."""

from portbench import spans


def read(ctx):
    return spans.median_ms(ctx, "train.h2d")
