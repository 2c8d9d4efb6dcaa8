"""video_trunk_enqueue_ms.serve: median ms of the program's
``video.trunk`` span (``qg_model._video``'s R(2+1)D trunk: the host
enqueueing its 37 convs, batchnorms and casts) over the traced generate()
calls."""

from portbench import spans


def read(ctx):
    return spans.median_ms(ctx, "video.trunk")
