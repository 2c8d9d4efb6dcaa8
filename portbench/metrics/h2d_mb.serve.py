"""h2d_mb.serve: MB (1e6 bytes) that ``QGPipeline._to_device`` ships a
call, from the program's counter ``pipeline.h2d_shipped`` over every call
of the run (the pool's batches repeat, so every pass ships the same)."""

from portbench import spans


def read(ctx):
    from mmqg_tpu_torch import pipeline

    return spans.shipped_mb(getattr(pipeline, "h2d_shipped", None))
