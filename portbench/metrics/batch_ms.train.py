"""batch_ms.train: median ms of the program's ``data.batch`` span
(``QGDataset.batches`` gathering one batch's rows on the host) over the
traced steps."""

from portbench import spans


def read(ctx):
    return spans.median_ms(ctx, "data.batch")
