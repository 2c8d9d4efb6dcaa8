"""h2d_pinned_share.serve: the share (0 to 1) of the run's
``QGPipeline._to_device`` calls that shipped from page-locked staging with
asynchronous copies, from the program's counter ``pipeline.h2d_staged``
(``{"pinned", "pageable", "allocated"}``); None for a program without
it."""


def read(ctx):
    from mmqg_tpu_torch import pipeline

    counter = getattr(pipeline, "h2d_staged", None)
    calls = counter["pinned"] + counter["pageable"] if counter else 0
    return counter["pinned"] / calls if calls else None
