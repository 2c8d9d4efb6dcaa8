"""The yardstick's arithmetic: the H100's published peaks, the roofline
bound, and the operations and bytes the model and its kernels need, from
shapes alone.

Operations count a multiply-add as two. Bytes count each input read once
and each output written once (intermediates the kernel keeps in memory,
such as K1's input projection, are not counted).
"""

from __future__ import annotations

from typing import Dict, Sequence

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12, "fp8": 1979e12}
HBM_BYTES_S = 3.35e12

# VGGish: (out channels, convs) per block, a 2x2 pool after each block
VGGISH_BLOCKS = ((64, 1), (128, 1), (256, 2), (512, 2))
VIDEO_CHANNELS = (4, 6, 8, 10)


def bound_s(ops: float, nbytes: float, peak: str) -> float:
    """The least time the card could take: the larger of the operations at
    ``peak`` and the bytes at the memory rate."""
    return max(ops / PEAK[peak], nbytes / HBM_BYTES_S)


def lstm_layer(B: int, T: int, In: int, H: int, op_bytes: int = 2
               ) -> Dict[str, float]:
    """One K1 launch: an LSTM layer of ``B`` rows over ``T`` steps. Ops:
    the input projection and the recurrence, 2 * B * T * 4H * (In + H),
    plus the cell's ~10 element-wise operations per hidden unit and step.
    Bytes: inputs and weights in the compute dtype (``op_bytes``), the f32
    bias, the f32 outputs, and the f32 initial and latched (h, c)."""
    ops = 2.0 * B * T * 4 * H * (In + H) + 10.0 * B * T * H
    nbytes = (op_bytes * (B * T * In + In * 4 * H + H * 4 * H) + 4 * 4 * H
              + 4 * B * T * H + 4 * 4 * B * H)
    return {"ops": ops, "bytes": nbytes}


def lstm_train_layer(B: int, T: int, In: int, H: int, op_bytes: int = 2
                     ) -> Dict[str, Dict[str, float]]:
    """One K4 layer's forward and backward launches. The forward is
    :func:`lstm_layer` that also writes the f32 gates (B, T, 4H) and cell
    states (B, T, H) the backward reads. The backward: the recurrence
    dh = dG Wh^T and the three gradient products dX = dG Wx^T,
    dWx = X^T dG, dWh = H^T dG, 2 * B * T * 4H * (2 In + 2 H) operations
    plus ~20 element-wise a hidden unit and step; it reads X (compute
    dtype), h, c, the gates and dY (f32) and the weights, and writes dX,
    dWx, dWh, db and the initial state's gradients (f32)."""
    f = lstm_layer(B, T, In, H, op_bytes)
    fwd = {"ops": f["ops"], "bytes": f["bytes"] + 4 * B * T * 5 * H}
    ops = 2.0 * B * T * 4 * H * (2 * In + 2 * H) + 20.0 * B * T * H
    nbytes = (op_bytes * (B * T * In + In * 4 * H + H * 4 * H)
              + 4 * B * T * (H + H + 4 * H + H)
              + 4 * (B * T * In + In * 4 * H + H * 4 * H + 4 * H + 2 * B * H))
    return {"fwd": fwd, "bwd": {"ops": ops, "bytes": nbytes}}


def conv3x3(N: int, H: int, W: int, Cin: int, Cout: int) -> float:
    """Operations of a 3x3 SAME conv over (N, H, W, Cin)."""
    return 2.0 * N * H * W * 9 * Cin * Cout


def vggish_int8_launches(N: int, mel_frames: int = 96, mel_bins: int = 64
                         ) -> Sequence[Dict[str, float]]:
    """The int8 tower's launches over ``N`` examples (conv2..conv6 and the
    quantizes that feed them), each {"ops", "bytes"}: conv2's input
    quantize reads conv1's pooled bf16 output and writes int8; each conv
    reads its int8 input and int8 weights, and writes bf16 (the dynamic
    scales' next quantize reads that and writes int8)."""
    out = []
    H, W = mel_frames // 2, mel_bins // 2          # after conv1 and its pool
    cin = VGGISH_BLOCKS[0][0]
    layers = []
    for c_out, reps in VGGISH_BLOCKS[1:]:
        for r in range(reps):
            layers.append((cin, c_out, r == reps - 1))
            cin = c_out
    P = H * W * layers[0][0]
    out.append({"ops": 2.0 * N * P, "bytes": N * P * (2 + 1)})
    for i, (ci, co, pool) in enumerate(layers):
        ho, wo = (H // 2, W // 2) if pool else (H, W)
        out.append({"ops": conv3x3(N, H, W, ci, co),
                    "bytes": N * H * W * ci + 9 * ci * co + 12 * co
                    + 4 * N + 2 * N * ho * wo * co})
        if i < len(layers) - 1:
            P = ho * wo * co
            out.append({"ops": 2.0 * N * P, "bytes": N * P * (2 + 1)})
        H, W = ho, wo
    return out


def vggish_flops(n_examples: int, mel_frames: int = 96, mel_bins: int = 64,
                 emb: int = 128) -> float:
    """Model FLOPs of the VGGish tower over ``n_examples``: six 3x3 convs
    and three fc layers."""
    H, W, cin, f = mel_frames, mel_bins, 1, 0.0
    for c_out, reps in VGGISH_BLOCKS:
        for _ in range(reps):
            f += conv3x3(1, H, W, cin, c_out)
            cin = c_out
        H, W = H // 2, W // 2
    flat = H * W * cin
    f += 2.0 * (flat * 4096 + 4096 * 4096 + 4096 * emb)
    return n_examples * f


def logmel_flops(n_frames: int, window_pad: int = 480, fft: int = 512,
                 mel_bins: int = 64) -> float:
    """The log-mel frontend as the model computes it: each frame against a
    (window, 2 * (fft/2 + 1)) windowed DFT basis, then the mel matrix."""
    F = fft // 2 + 1
    return 2.0 * n_frames * (window_pad * 2 * F + F * mel_bins)


def video_cnn_flops(n_frames: int, size: int = 112) -> float:
    """The conv pyramid of the video encoder over ``n_frames`` frames:
    four 3x3 VALID convs, a 3x3 pool after the second and the fourth."""
    s, cin, f = size, 3, 0.0
    for i, c_out in enumerate(VIDEO_CHANNELS):
        s -= 2
        f += 2.0 * n_frames * s * s * 9 * cin * c_out
        cin = c_out
        if i in (1, 3):
            s //= 3
    return f


def lstm_flops(T: int, In: int, H: int) -> float:
    """One row of an LSTM layer over ``T`` steps (matrix products only)."""
    return 2.0 * T * 4 * H * (In + H)


def request_flops(cfg: Dict, text_len: int, n_frames: int, n_examples: int,
                  steps: int) -> float:
    """Model FLOPs one served request needs at its real lengths: the text
    LSTM over its tokens, the video tower over its frames, the audio
    frontend and VGGish over its whole examples (trimodal), and ``steps``
    decoder steps (attention over the three memories, the decoder LSTM
    and the vocabulary projection)."""
    D, H = cfg["word_emb_dim"], cfg["hidden_dim"]
    Hv, Ha, V = cfg["video_hidden_dim"], cfg["audio_emb_dim"], cfg["n_vocab"]
    Lc, La = cfg["context_max_length"], cfg["av_max_length"]
    f = sum(lstm_flops(text_len, D if i == 0 else H, H)
            for i in range(cfg["text_layers"]))
    mode = cfg["mode"]
    if mode in ("text_video", "trimodal"):
        f += video_cnn_flops(n_frames, cfg["frame_size"])
        f += lstm_flops(n_frames, cfg["flatten_dim"], Hv)
    if mode == "trimodal":
        f += logmel_flops(n_examples * cfg["mel_frames"])
        f += vggish_flops(n_examples, cfg["mel_frames"], cfg["mel_bins"], Ha)
    if cfg["decoder"] == "attn":
        q = D + H
        per_step = (2.0 * q * (Lc + 2 * La)
                    + 2.0 * (text_len * H + n_frames * Hv + n_examples * Ha))
        dec_in = D + H + Ha + Hv
    else:
        per_step = 0.0
        dec_in = D + Ha + Hv
    per_step += sum(2.0 * 4 * H * ((dec_in if i == 0 else H) + H)
                    for i in range(cfg["dec_layers"]))
    per_step += 2.0 * H * V
    return f + steps * per_step
