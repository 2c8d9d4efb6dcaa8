"""optimizer_ms.train: median ms of the program's ``train.optimizer`` span
(from collecting the gradient tree through ``apply_updates``: Adam, the
norm and the update) over the traced steps."""

from portbench import spans


def read(ctx):
    return spans.median_ms(ctx, "train.optimizer")
