"""h2d_mb.train: MB (1e6 bytes) that ``train.to_device`` ships a call,
from the program's counter ``train.h2d_shipped`` over every call of the
run (every batch has the dataset's fixed shapes)."""

from portbench import spans


def read(ctx):
    from mmqg_tpu_torch import train

    return spans.shipped_mb(getattr(train, "h2d_shipped", None))
