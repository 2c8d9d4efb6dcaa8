"""The Video Swin Transformer's operations and bytes from shapes
(``arith.py``'s conventions: a multiply-add is two operations; a launch
reads each input byte once and writes each output byte once), and the
model FLOPs of a request served with it as the video encoder.

The model count is the trunk at a clip's own tokens: ceil(n / 2) x H' x
W' at stage 1, each token's window attention over the window's volume
(392 tokens, or the axis where an axis is no longer than the window).
The attention count for its roofline is the work of every window that
holds a live token, at the shapes its batch was served at.
"""

from __future__ import annotations

from typing import Dict, Iterator, Sequence, Tuple

from portbench import arith

EMBED, DEPTHS, HEADS = 128, (2, 2, 18, 2), (4, 8, 16, 32)
PATCH, WINDOW = (2, 4, 4), (8, 7, 7)
TABLE = (2 * WINDOW[0] - 1) * (2 * WINDOW[1] - 1) * (2 * WINDOW[2] - 1)


def _ceil(n: int, d: int) -> int:
    return -(-n // d)


def memory_steps(n_frames: int) -> int:
    return max(1, _ceil(n_frames, PATCH[0]))


def stages(n_frames: int, size: int = 224, embed: int = EMBED
           ) -> Iterator[Tuple[int, Tuple[int, int, int]]]:
    """(width C, tokens (T', H', W')) of each stage over one clip."""
    t, h, w = (_ceil(n, p) for n, p in zip((n_frames, size, size), PATCH))
    c = embed
    for s in range(len(DEPTHS)):
        if s:
            h, w, c = _ceil(h, 2), _ceil(w, 2), 2 * c
        yield c, (t, h, w)


def window_of(size: Sequence[int], shifted: bool
              ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """torchvision's window and shift of a block over (T, H, W)."""
    win = tuple(min(n, k) for n, k in zip(size, WINDOW))
    shift = tuple(k // 2 if shifted and n > k else 0
                  for n, k in zip(size, WINDOW))
    return win, shift


def trunk_macs(n_frames: int, size: int = 224, embed: int = EMBED,
               depths: Sequence[int] = DEPTHS) -> Dict[str, int]:
    """Multiply-adds of the trunk over one clip, by part: ``patch`` (the
    embedding's GEMM), ``linear`` (qkv, proj and the MLP, 12 N C^2 a
    block), ``attention`` (q k^T and AV, 2 N V C a block, V the window's
    volume), ``merge`` (N' 4C 2C each)."""
    out = {"patch": 0, "linear": 0, "attention": 0, "merge": 0}
    for s, (c, (t, h, w)) in enumerate(stages(n_frames, size, embed)):
        n = t * h * w
        if s == 0:
            out["patch"] = n * 3 * PATCH[0] * PATCH[1] * PATCH[2] * c
        else:
            out["merge"] = out["merge"] + n * 4 * (c // 2) * c
        vol = 1
        for k in window_of((t, h, w), False)[0]:
            vol *= k
        out["linear"] += depths[s] * 12 * n * c * c
        out["attention"] += depths[s] * 2 * n * vol * c
    return out


def trunk_flops(n_frames: int, size: int = 224) -> float:
    """Model FLOPs of the trunk over one clip."""
    return 2.0 * sum(trunk_macs(n_frames, size).values())


def _live_windows(t: int, live: int, win: int, shift: int) -> int:
    """Temporal windows of a padded, rolled axis of ``t`` tokens (padded
    to ``win``) holding a token below ``live``."""
    tp = _ceil(t, win) * win
    return sum(any((p + shift) % tp < live
                   for p in range(k * win, (k + 1) * win))
               for k in range(tp // win))


def attention_windows(frames: Sequence[int], clip: int, size: int = 224
                      ) -> Iterator[Dict[str, int]]:
    """Each block's window attention of one batch: clips of ``frames``
    (their real lengths), all encoded at ``clip`` frames. ``windows``
    computed, ``live`` those holding a token before its clip's length,
    ``tokens`` (their volume), ``width`` and ``heads``."""
    t = memory_steps(clip)
    for s, (c, (_, h, w)) in enumerate(stages(clip, size)):
        for i in range(DEPTHS[s]):
            win, shift = window_of((t, h, w), i % 2 == 1)
            spatial = _ceil(h, win[1]) * _ceil(w, win[2])
            per_clip = _ceil(t, win[0]) * spatial
            live = sum(_live_windows(t, memory_steps(n), win[0], shift[0])
                       for n in frames) * spatial
            yield {"windows": per_clip * len(frames), "live": live,
                   "tokens": win[0] * win[1] * win[2], "width": c,
                   "heads": HEADS[s]}


def attention_launches(frames: Sequence[int], clip: int, size: int = 224,
                       op_bytes: int = 2) -> Iterator[Dict[str, float]]:
    """Each block's attention as the roofline counts it: for every window
    with a live token, 2 V^2 C multiply-adds (q k^T and AV); bytes, q, k,
    v and the output of those windows in the compute dtype (``op_bytes``)
    and the block's float32 bias table, once each."""
    for a in attention_windows(frames, clip, size):
        v, c = a["tokens"], a["width"]
        yield {"ops": 2.0 * a["live"] * 2 * v * v * c,
               "bytes": op_bytes * 4 * a["live"] * v * c
               + 4 * TABLE * a["heads"]}


def request_flops(cfg: Dict, text_len: int, n_frames: int, n_examples: int,
                  steps: int) -> float:
    """``arith.request_flops`` with the Video Swin trunk in the conv-LSTM
    video tower's place: the base count with the video memory's ceil(n /
    2) steps (what the decoder attends over), less the conv pyramid and
    its LSTM over those steps, plus the trunk over the request's
    frames."""
    m = memory_steps(n_frames)
    f = arith.request_flops(cfg, text_len, m, n_examples, steps)
    f -= arith.video_cnn_flops(m, cfg["frame_size"])
    f -= arith.lstm_flops(m, cfg["flatten_dim"], cfg["video_hidden_dim"])
    return f + trunk_flops(n_frames, cfg["frame_size"])

