"""Salient frames of a lecture video's answer spans
(``mmqg_tpu/data/saliency.py``): every ``ceil(fps)``-th frame whose time
lies in a span, resized to the model's frame size, uint8 BGR, one decode
of the file for all its spans.

Two routes give them, as in the JAX package: the native seek-decoder
(``data/native.py``; only the spans' keyframe neighbourhoods decode, the
resize is libswscale's SWS_AREA) and cv2's linear decode of the whole
file (INTER_AREA). The two agree up to the resize's rounding, not byte for
byte. ``MMQG_NATIVE_FRAMES=0`` forces cv2. Each call counts the route that
served it in ``frame_routes``. The offline corpus prep stays in the JAX
package.
"""

from __future__ import annotations

import math
import os
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from mmqg_tpu_torch.data.subtitles import span_seconds

# calls of extract_salient_frames_for_video by the route that served them
frame_routes = {"native": 0, "cv2": 0}
_routes_lock = threading.Lock()  # prep pools call from several threads


def _count(route: str) -> None:
    with _routes_lock:
        frame_routes[route] += 1


def parse_span_ms(answer_start: str, answer_end: str) -> Tuple[int, int]:
    """'M:SS' strings -> (start_ms, end_ms)."""
    return span_seconds(answer_start) * 1000, span_seconds(answer_end) * 1000


def is_salient(frame_time: float, start_time: float, end_time: float) -> bool:
    return start_time <= frame_time <= end_time


def _native_salient_frames(
    video_file: Path,
    spans_ms: Sequence[Tuple[int, int]],
    frame_dim: Tuple[int, int],
) -> Optional[List[np.ndarray]]:
    """The salient frames by the native seek-decoder, with the cv2 route's
    sampling rule; None when that route cannot serve this file (the caller
    decodes with cv2)."""
    from mmqg_tpu_torch.data import native

    if os.environ.get("MMQG_NATIVE_FRAMES", "1") == "0":
        return None
    if frame_dim[0] != frame_dim[1]:
        return None  # the native resize is square-only
    try:
        info = native.video_info(video_file)
    except ValueError:
        return None  # readable container, no video stream: cv2 decides
    if not info or not info["fps"] or info["fps"] <= 0:
        return None
    fps = info["fps"]  # the container rate, the value cv2 reports
    step = math.ceil(fps)  # every ceil(fps)-th frame, ~1 fps

    # CANDIDATE indices: multiples of `step` whose estimated time falls in
    # a span widened by 2 sample periods (the container's avg_frame_rate
    # can be skewed against the true pts). The exact in-span test below
    # uses each frame's true pts, as the cv2 route's CAP_PROP_POS_MSEC.
    slack_ms = 2 * step * 1000.0 / fps
    n_frames = info["n_frames"] or 0
    # a recorded frame count is a hard bound; an estimated one can
    # undercount by a frame or two, so pad it (past-EOF indices come back
    # missing, which is safe)
    bound = n_frames if info.get("n_frames_exact") else (
        n_frames + 2 * step if n_frames else 0)
    wanted: set = set()
    for start_ms, end_ms in spans_ms:
        f = max(0, math.floor((start_ms - slack_ms) * fps / 1000.0
                              / step)) * step
        while f * 1000.0 / fps <= end_ms + slack_ms:
            if bound and f >= bound:
                break
            wanted.add(f)
            f += step
    order = sorted(wanted)
    if not order:
        return [np.zeros((0,) + frame_dim + (3,), np.uint8) for _ in spans_ms]

    res = native.decode_frames(video_file, order, frame_dim[0])
    if res is None:
        return None
    frames, found, pts_s, tick_s = res
    if not found.all():
        if info.get("n_frames_exact"):
            # indices inside the declared frame count failed to decode on
            # the CFR grid (VFR stream, drops): use the linear route
            return None
        # inexact bound: only a SUFFIX of misses (past the real EOF) is
        # expected; an interior miss means an off-grid stream
        miss = np.flatnonzero(~found)
        if found[miss[0]:].any():
            return None

    # cv2's CAP_PROP_POS_MSEC is read BEFORE grab() and so lags one frame:
    # frame k is tested against pts(k-1), and frame 0 against 0.0.
    # Reproduce that, so both routes select the same frames.
    lag_ms = [(pts_s[i] - tick_s) * 1000.0 if order[i] > 0 else 0.0
              for i in range(len(order))]
    out = []
    for start_ms, end_ms in spans_ms:
        kept = [frames[i] for i in range(len(order))
                if found[i] and is_salient(lag_ms[i], start_ms, end_ms)]
        out.append(np.asarray(kept, np.uint8) if kept
                   else np.zeros((0,) + frame_dim + (3,), np.uint8))
    return out


def extract_salient_frames_for_video(
    video_file: Path,
    spans_ms: Sequence[Tuple[int, int]],
    frame_dim: Tuple[int, int] = (112, 112),
) -> List[np.ndarray]:
    """Decode ``video_file`` once; for each (start_ms, end_ms) span return
    the ~1 fps salient frames resized to ``frame_dim`` as uint8
    (T, H, W, 3): frames with ``frame_id % ceil(fps) == 0`` whose time lies
    in the span. The native seek-decoder serves first; cv2's linear decode
    (grab() every frame, retrieve() only the kept ones) when it cannot."""
    if Path(video_file).exists():
        native_out = _native_salient_frames(video_file, spans_ms, frame_dim)
        if native_out is not None:
            _count("native")
            return native_out

    import cv2

    cap = cv2.VideoCapture(str(video_file))
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video: {video_file}")
    frame_rate = math.ceil(cap.get(cv2.CAP_PROP_FPS))
    per_span: List[List[np.ndarray]] = [[] for _ in spans_ms]
    while True:
        frame_id = cap.get(cv2.CAP_PROP_POS_FRAMES)
        frame_time = cap.get(cv2.CAP_PROP_POS_MSEC)
        if not cap.grab():
            break
        if frame_id % frame_rate != 0:
            continue
        wanted = any(is_salient(frame_time, s, e) for s, e in spans_ms)
        if not wanted:
            continue
        ok, image = cap.retrieve()
        if not ok:
            break
        resized = cv2.resize(image, frame_dim, interpolation=cv2.INTER_AREA)
        for i, (start_ms, end_ms) in enumerate(spans_ms):
            if is_salient(frame_time, start_ms, end_ms):
                per_span[i].append(resized)
    cap.release()
    _count("cv2")
    return [
        np.asarray(frames, dtype=np.uint8)
        if frames else np.zeros((0,) + frame_dim + (3,), np.uint8)
        for frames in per_span
    ]
