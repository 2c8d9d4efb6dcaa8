"""swin3d_padded_tokens.serve: the share of the window attention's
tokens (its rows) that lie at or past their clip's temporal length, 1 -
``live_tokens`` / ``tokens`` of the program's counter
``video_swin.windows`` over the run: what a kernel that skips padded
windows could leave out. A fraction; None for a program without the
counter or before a trunk ran."""


def read(ctx):
    try:
        from mmqg_tpu_torch.models import video_swin
    except ImportError:
        return None
    counter = getattr(video_swin, "windows", None)
    if not counter or not counter.get("tokens"):
        return None
    return 1.0 - float(counter["live_tokens"]) / counter["tokens"]
