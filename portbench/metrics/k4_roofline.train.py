"""k4_roofline.train: K4 (``ops/lstm_train.py``, ``csrc/lstm_train.cu`` and
``csrc/lstm.cuh``: the forward's input GEMM and sweep, the backward's
sweep and gradient GEMMs) against its roofline over the traced steps: the
launches' bound time (operations at the bf16 peak or bytes at 3.35 TB/s)
over the device time of its kernels, per cent. A step runs K4 forward and
backward once per text layer over the padded context and once for the
video LSTM over the step's frames bucket."""

from portbench import arith
from portbench.readers import roofline_pct

KERNELS = (r"\bgemm_kernel<", r"\btc_gemm_kernel<", r"\bfwd_sweep_kernel<",
           r"\bfwd_step_kernel<", r"\bbwd_sweep_kernel", r"\bbwd_step_kernel",
           r"\bcolsum_kernel")


def launches(cfg, step):
    B, H, D = step["rows"], cfg["hidden_dim"], cfg["word_emb_dim"]
    shapes = [(cfg["context_max_length"], D if li == 0 else H, H)
              for li in range(cfg["text_layers"])]
    if cfg["mode"] in ("text_video", "trimodal"):
        shapes.append((step.get("frames_cap") or cfg["av_max_length"],
                       cfg["flatten_dim"], cfg["video_hidden_dim"]))
    for T, In, Hh in shapes:
        k = arith.lstm_train_layer(B, T, In, Hh)
        yield k["fwd"]
        yield k["bwd"]


def read(ctx):
    return roofline_pct(dict(ctx, calls=ctx.get("steps")), KERNELS, launches,
                        "bf16")
