"""forward_ms.train: median over the traced steps of the ms a step spends
in the program's ``train.forward`` spans (``qg_model.loss_fn`` of each
microbatch, enqueueing the forward)."""

from portbench import spans


def read(ctx):
    return spans.per_step_median_ms(ctx, "train.forward")
