"""r2plus1d_unaligned_convs.serve: convs a trunk runs whose input or
output channels are not a multiple of 8 (cuDNN's bf16 tensor-core kernels
need both), from the program's counter ``video_resnet.convs``
(``{"trunks", "aligned", "unaligned"}``) over the run; None for a program
without it."""


def read(ctx):
    from mmqg_tpu_torch.models import video_resnet

    counter = getattr(video_resnet, "convs", None)
    if not counter or not counter.get("trunks"):
        return None
    return counter["unaligned"] / counter["trunks"]
