"""backward_ms.train: median over the traced steps of the ms a step spends
in the program's ``train.backward`` spans (autograd's backward of each
microbatch)."""

from portbench import spans


def read(ctx):
    return spans.per_step_median_ms(ctx, "train.backward")
