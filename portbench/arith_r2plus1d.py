"""R(2+1)D-18's operations and bytes from shapes (``arith.py``'s
conventions: a multiply-add is two operations; a launch reads each input
byte once and writes each output byte once), and the model FLOPs of a
request served with it as the video encoder.

Every conv pads k // 2 on each axis, so an axis of length n strided by s
comes out ceil(n / s) long.
"""

from __future__ import annotations

from typing import Dict, Iterator

from portbench import arith

STAGES = (64, 128, 256, 512)


def _out(n: int, s: int) -> int:
    return -(-n // s)


def midplanes(cin: int, cout: int) -> int:
    return (27 * cin * cout) // (9 * cin + 3 * cout)


def trunk_convs(n_frames: int, size: int = 112) -> Iterator[Dict]:
    """The trunk's 37 convs over one clip of ``n_frames`` frames of
    ``size`` x ``size``, in launch order: ``cin``, ``cout``, kernel ``k``
    (kt, kh, kw) and the input and output extents ``inp``, ``out`` (T, H,
    W)."""
    shape = (n_frames, size, size)

    def conv(cin, cout, k, stride):
        nonlocal shape
        out = tuple(_out(n, s) for n, s in zip(shape, stride))
        d = {"cin": cin, "cout": cout, "k": k, "inp": shape, "out": out}
        shape = out
        return d

    yield conv(3, 45, (1, 7, 7), (1, 2, 2))
    yield conv(45, 64, (3, 1, 1), (1, 1, 1))
    cin = 64
    for si, cout in enumerate(STAGES):
        for bi in range(2):
            s = 2 if (bi == 0 and si > 0) else 1
            m = midplanes(cin, cout)
            block_in = shape
            yield conv(cin, m, (1, 3, 3), (1, s, s))
            yield conv(m, cout, (3, 1, 1), (s, 1, 1))
            yield conv(cout, m, (1, 3, 3), (1, 1, 1))
            yield conv(m, cout, (3, 1, 1), (1, 1, 1))
            if s == 2:                 # the shortcut, from the block's input
                shape = block_in
                yield conv(cin, cout, (1, 1, 1), (2, 2, 2))
            cin = cout


def conv_macs(c: Dict) -> int:
    """Multiply-adds of one conv over one clip."""
    T, H, W = c["out"]
    kt, kh, kw = c["k"]
    return T * H * W * c["cout"] * c["cin"] * kt * kh * kw


def trunk_flops(n_frames: int, size: int = 112) -> float:
    """Model FLOPs of the trunk over one clip."""
    return 2.0 * sum(conv_macs(c) for c in trunk_convs(n_frames, size))


def trunk_launches(rows: int, clip: int, size: int = 112,
                   op_bytes: int = 2) -> Iterator[Dict[str, float]]:
    """Each conv launch of one batch: ``rows`` clips of ``clip`` frames;
    operations, and bytes of the input, the weight and the output in the
    compute dtype (``op_bytes``)."""
    for c in trunk_convs(clip, size):
        kt, kh, kw = c["k"]
        n_in = rows * c["inp"][0] * c["inp"][1] * c["inp"][2] * c["cin"]
        n_out = rows * c["out"][0] * c["out"][1] * c["out"][2] * c["cout"]
        n_w = kt * kh * kw * c["cin"] * c["cout"]
        yield {"ops": 2.0 * rows * conv_macs(c),
               "bytes": op_bytes * (n_in + n_w + n_out)}


def memory_steps(n_frames: int) -> int:
    return max(1, _out(n_frames, 8))


def request_flops(cfg: Dict, text_len: int, n_frames: int, n_examples: int,
                  steps: int) -> float:
    """``arith.request_flops`` with R(2+1)D-18 in the conv-LSTM video
    tower's place: the base count with the video memory's ceil(n / 8)
    steps (what the decoder attends over), less the conv pyramid and its
    LSTM over those steps, plus the trunk over the request's frames."""
    m = memory_steps(n_frames)
    f = arith.request_flops(cfg, text_len, m, n_examples, steps)
    f -= arith.video_cnn_flops(m, cfg["frame_size"])
    f -= arith.lstm_flops(m, cfg["flatten_dim"], cfg["video_hidden_dim"])
    return f + trunk_flops(n_frames, cfg["frame_size"])
