"""k1_roofline.serve: K1 (``ops/lstm.py``, ``csrc/lstm_seq.cu`` and
``csrc/lstm.cuh``: the input-projection GEMM and the recurrence sweep)
against its roofline: the launches' bound time (operations at the bf16
peak or bytes at 3.35 TB/s, whichever is larger) over the device time of
its kernels, per cent. A generate() launches K1 once per text layer over
the whole padded context and once for the video LSTM over the frames
bucket, on every packed row."""

from portbench import arith
from portbench.readers import roofline_pct

KERNELS = (r"\bgemm_kernel<", r"\btc_gemm_kernel<", r"\bfwd_sweep_kernel<",
           r"\bfwd_step_kernel<")


def launches(cfg, call):
    B, H, D = call["rows"], cfg["hidden_dim"], cfg["word_emb_dim"]
    for li in range(cfg["text_layers"]):
        yield arith.lstm_layer(B, cfg["context_max_length"],
                               D if li == 0 else H, H)
    if cfg["mode"] in ("text_video", "trimodal"):
        yield arith.lstm_layer(B, call["fcap"], cfg["flatten_dim"],
                               cfg["video_hidden_dim"])


def read(ctx):
    return roofline_pct(ctx, KERNELS, launches, "bf16")
