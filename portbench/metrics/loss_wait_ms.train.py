"""loss_wait_ms.train: median ms of the program's ``train.loss_read`` span
(``run_epoch`` reading a step's loss, two steps behind: the host's wait
for the card) over the traced steps."""

from portbench import spans


def read(ctx):
    return spans.median_ms(ctx, "train.loss_read")
