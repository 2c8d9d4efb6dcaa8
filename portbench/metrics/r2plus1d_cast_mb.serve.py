"""r2plus1d_cast_mb.serve: MB (1e6 bytes) a trunk's per-call weight casts
write (``Conv3d.forward`` lays each f32 weight out in the compute dtype),
from the program's counters ``video_resnet.weight_casts`` (``{"calls",
"bytes"}``) and ``video_resnet.convs``'s ``trunks`` over the run; None for
a program without them."""


def read(ctx):
    from mmqg_tpu_torch.models import video_resnet

    casts = getattr(video_resnet, "weight_casts", None)
    convs = getattr(video_resnet, "convs", None)
    if not casts or not convs or not convs.get("trunks"):
        return None
    return casts["bytes"] / convs["trunks"] / 1e6
