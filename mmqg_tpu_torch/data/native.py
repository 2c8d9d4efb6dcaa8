"""ctypes bindings for the native host libraries (``mmqg_tpu/data/native.py``):

* the media library, ``native/mmqg_media.cpp``: container demux, audio
  decode and resampling, and seek-decode of video frames by index, through
  the system's libav libraries;
* the host runtime, ``native/mmqg_host.cpp`` (:func:`get_lib`): the
  single-file loaders (:func:`load_wav_mono`, :func:`load_frames`) and
  the threaded batch packer that fills a batch's frame and audio buffers
  from the corpus's ``.npy`` and ``.wav`` files while the device runs the
  previous batch (:func:`pack_batch_async`, for ``data.streaming``).

The C++ sources lie outside both packages and are compiled as they are,
with g++, into this package's own ``build/native/`` (gitignored) at first
use: not into ``native/``, where the JAX package's ``make -C native``
builds the same libraries, so that two test workers on a fresh checkout
never load a file the other is still writing. A library is written under
a temporary name and moved into place with ``os.replace``; it is rebuilt
when its source is newer. When a library cannot be built or loaded its
getter returns None and the callers take their other routes (cv2 frames;
staged wavs or the ffmpeg binary for audio; packing in Python), which they
count (``saliency.frame_routes``, ``pipeline.audio_routes``,
``streaming.pack_routes``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import warnings
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
MEDIA_SRC = _PKG.parent / "native" / "mmqg_media.cpp"
HOST_SRC = _PKG.parent / "native" / "mmqg_host.cpp"
BUILD_DIR = _PKG / "build" / "native"
MEDIA_LIB_PATH = BUILD_DIR / "libmmqg_media.so"
HOST_LIB_PATH = BUILD_DIR / "libmmqg_host.so"
# native/Makefile's CXXFLAGS and LDFLAGS defaults and its `media` rule's
# libraries (native/Makefile:1-3,13-17)
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra")
LD_FLAGS = ("-shared", "-pthread")
LIBS = ("-lavformat", "-lavcodec", "-lavutil", "-lswresample", "-lswscale")

_media_lib = None
_media_tried = False  # set once the build and load have been attempted
_host_lib = None
_host_tried = False
# the prep thread pools call the getters concurrently on first use: one
# builds and loads, the others wait for it under the lock
_load_lock = threading.Lock()


def _build_lib(src: Path, out: Path, libs=()) -> None:
    """Compile ``src`` into the shared library ``out`` (raises on
    failure)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(src), *LD_FLAGS, *libs,
                        "-o", str(tmp)], check=True, capture_output=True,
                       timeout=120)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)


def _built(src: Path, out: Path, libs=()) -> bool:
    """Whether ``out`` exists, (re)building it first when it is missing or
    older than ``src``. A failed rebuild of a stale library keeps the old
    one, with a warning."""
    stale = (out.exists() and src.exists()
             and src.stat().st_mtime > out.stat().st_mtime)
    if not out.exists() or stale:
        try:
            _build_lib(src, out, libs)
        except (OSError, subprocess.SubprocessError):
            if not out.exists():
                return False
            warnings.warn(f"native lib rebuild failed; using the STALE {out}",
                          RuntimeWarning)
    return True


def get_media_lib() -> Optional[ctypes.CDLL]:
    """The loaded media library, built first if missing or stale; None
    when it cannot be built or loaded on this host.

    Unlike the JAX package's copy, a thread that calls while another is
    building waits for the build: the "attempted" flag is set only after
    the attempt, so a concurrent first call cannot see it set with no
    library yet and take the fallback route."""
    global _media_lib, _media_tried
    if _media_tried:
        return _media_lib
    with _load_lock:
        if not _media_tried:
            try:
                _media_lib = _load_media_lib()
            finally:
                _media_tried = True
    return _media_lib


def _load_media_lib() -> Optional[ctypes.CDLL]:
    if not _built(MEDIA_SRC, MEDIA_LIB_PATH, LIBS):
        return None
    try:
        lib = ctypes.CDLL(str(MEDIA_LIB_PATH))
    except OSError:
        return None
    lib.mmqg_media_duration.restype = ctypes.c_double
    lib.mmqg_media_duration.argtypes = [ctypes.c_char_p]
    lib.mmqg_decode_audio.restype = ctypes.c_long
    lib.mmqg_decode_audio.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_int16), ctypes.c_long]
    if hasattr(lib, "mmqg_decode_audio_spans"):  # absent in stale builds
        lib.mmqg_decode_audio_spans.restype = ctypes.c_long
        lib.mmqg_decode_audio_spans.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.c_long, ctypes.POINTER(ctypes.c_int16),
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_long)]
    lib.mmqg_media_video_info.restype = ctypes.c_long
    lib.mmqg_media_video_info.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long)]
    lib.mmqg_decode_frames_idx2.restype = ctypes.c_long
    lib.mmqg_decode_frames_idx2.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_long), ctypes.c_long,
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double)]
    lib.mmqg_write_test_tone_mp4.restype = ctypes.c_long
    lib.mmqg_write_test_tone_mp4.argtypes = [
        ctypes.c_char_p, ctypes.c_double, ctypes.c_int]
    lib.mmqg_write_test_av_mp4.restype = ctypes.c_long
    lib.mmqg_write_test_av_mp4.argtypes = [
        ctypes.c_char_p, ctypes.c_double, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    return lib


def media_available() -> bool:
    return get_media_lib() is not None


def media_duration(path) -> Optional[float]:
    """Container duration in seconds; None if lib unavailable / unreadable."""
    lib = get_media_lib()
    if lib is None:
        return None
    d = lib.mmqg_media_duration(str(path).encode())
    return None if d < 0 else float(d)


def decode_audio(path, target_rate: int, *, channels: int = 1,
                 start: float = 0.0, end: Optional[float] = None,
                 max_seconds: Optional[float] = None) -> Optional[np.ndarray]:
    """First audio stream of any container -> int16 PCM at ``target_rate``.

    Returns shape (n,) for mono or (n, channels); None when the media lib
    is unavailable or the file can't be decoded (the caller falls back to
    the ffmpeg binary). Raises ValueError for a readable file WITHOUT an
    audio stream: that is a caller error, not a missing capability."""
    lib = get_media_lib()
    if lib is None:
        return None
    if max_seconds is None:
        if end is not None:
            max_seconds = max(end - start, 0.0)
        else:
            dur = media_duration(path)
            if dur is None:
                return None
            max_seconds = max(dur - start, 0.0)
    # +1 s slack: codec priming/padding can run past the nominal duration
    max_frames = int(max_seconds * target_rate) + target_rate
    out = np.zeros((max_frames * channels,), np.int16)
    n = lib.mmqg_decode_audio(
        str(path).encode(), target_rate, channels,
        float(start), float(end) if end is not None else 0.0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), max_frames)
    if n == -2:
        raise ValueError(f"{path}: no audio stream")
    if n < 0:
        return None
    pcm = out[: n * channels]
    return pcm if channels == 1 else pcm.reshape(-1, channels)


def decode_audio_spans(path, target_rate: int,
                       spans: Sequence, *,
                       channels: int = 1) -> Optional[List[np.ndarray]]:
    """Decode many [start, end) spans of one file's audio with ONE demux
    and decoder open: each span's PCM is byte-identical to its own
    ``decode_audio`` call (each span seeks and flushes), for one open.

    ``spans``: (start_s, end_s) pairs; end_s may be None for to-EOF.
    Returns a list of int16 arrays, or None when the lib or its symbol is
    unavailable or any span fails (the caller falls back to per-span or
    ffmpeg routes). Raises ValueError for a readable file WITHOUT an audio
    stream."""
    lib = get_media_lib()
    if lib is None or not hasattr(lib, "mmqg_decode_audio_spans"):
        return None
    spans = list(spans)
    if not spans:
        return []
    dur = None
    max_frames = []
    for start, end in spans:
        if end is None:
            if dur is None:
                dur = media_duration(path)
                if dur is None:
                    return None
            seconds = max(dur - start, 0.0)
        else:
            seconds = max(end - start, 0.0)
        # +1 s slack: codec priming/padding can run past the nominal span
        max_frames.append(int(seconds * target_rate) + target_rate)
    n = len(spans)
    starts = np.array([s for s, _ in spans], np.float64)
    ends = np.array([(e if e is not None else 0.0) for _, e in spans],
                    np.float64)
    caps = np.array(max_frames, np.int64)
    offsets = np.concatenate(([0], np.cumsum(caps)[:-1]))
    written = np.zeros(n, np.int64)
    out = np.zeros((int(caps.sum()) * channels,), np.int16)
    rc = lib.mmqg_decode_audio_spans(
        str(path).encode(), target_rate, channels,
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ends.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        caps.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        written.ctypes.data_as(ctypes.POINTER(ctypes.c_long)))
    if rc == -2:
        raise ValueError(f"{path}: no audio stream")
    if rc != 0:
        return None
    result = []
    for i in range(n):
        lo = int(offsets[i]) * channels
        pcm = out[lo: lo + int(written[i]) * channels].copy()
        result.append(pcm if channels == 1 else pcm.reshape(-1, channels))
    return result


def video_info(path) -> Optional[dict]:
    """Video stream metadata: {fps, duration, n_frames, n_frames_exact,
    width, height}.

    ``n_frames`` is the container's recorded frame count when present
    (``n_frames_exact`` True), else an estimate from duration * fps, which
    can undercount by a frame or two. None when the media lib is
    unavailable or the file is unreadable; ValueError when the file is
    readable but has no video stream."""
    lib = get_media_lib()
    if lib is None:
        return None
    fps = ctypes.c_double()
    dur = ctypes.c_double()
    nf = ctypes.c_long()
    w = ctypes.c_long()
    h = ctypes.c_long()
    rc = lib.mmqg_media_video_info(str(path).encode(), ctypes.byref(fps),
                                   ctypes.byref(dur), ctypes.byref(nf),
                                   ctypes.byref(w), ctypes.byref(h))
    if rc == -2:
        raise ValueError(f"{path}: no video stream")
    if rc != 0:
        return None
    exact = nf.value > 0
    n_frames = nf.value if exact else int(round(dur.value * fps.value))
    return {"fps": fps.value, "duration": dur.value, "n_frames": n_frames,
            "n_frames_exact": exact, "width": w.value, "height": h.value}


def decode_frames(path, indices, size: int, *,
                  seek_ahead_s: float = 0.0, skip: Optional[bool] = None,
                  legs: Optional[dict] = None):
    """Video frames by display index (any order, unique) resized to
    ``size`` x ``size`` BGR uint8, the cv2 salient-frame byte layout,
    seeking to the keyframe at or before each target instead of decoding
    the whole file.

    ``skip`` (default on; ``MMQG_FRAME_SKIP=0`` turns it off) lets the
    decoder skip reconstructing frames between targets; the emitted bytes
    are the same either way. ``legs``: optional dict that receives the
    per-stage wall-clock breakdown {open_s, seek_s, decode_s, sws_s}.

    Returns (frames, found, pts_s, tick_s): frames uint8 (n, size, size,
    3), found a bool mask (False where the index had no frame: past EOF,
    or a VFR stream off the CFR grid; those rows are zeros), pts_s each
    frame's timestamp in seconds from the first frame, and tick_s the
    frame interval. None when the media lib is unavailable or the file is
    unreadable; ValueError when it has no video stream."""
    lib = get_media_lib()
    if lib is None:
        return None
    if skip is None:
        skip = os.environ.get("MMQG_FRAME_SKIP", "1") != "0"
    idx = np.asarray(indices, np.int64)
    order = np.argsort(idx, kind="stable")  # the C side wants ascending
    sorted_idx = np.ascontiguousarray(idx[order])
    out = np.zeros((len(idx), size, size, 3), np.uint8)
    found = np.zeros((len(idx),), np.uint8)
    pts = np.zeros((len(idx),), np.float64)
    tick = ctypes.c_double(0.0)
    leg_arr = np.zeros((4,), np.float64)
    rc = lib.mmqg_decode_frames_idx2(
        str(path).encode(),
        sorted_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        len(idx), size, size, float(seek_ahead_s), 1 if skip else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        found.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.byref(tick),
        leg_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if legs is not None:
        legs.update(open_s=float(leg_arr[0]), seek_s=float(leg_arr[1]),
                    decode_s=float(leg_arr[2]), sws_s=float(leg_arr[3]))
    if rc == -2:
        raise ValueError(f"{path}: no video stream")
    if rc < 0:
        return None
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    return out[inv], found[inv].astype(bool), pts[inv], tick.value


def write_test_tone_mp4(path, seconds: float = 2.0, freq: int = 440) -> bool:
    """AAC-in-mp4 sine fixture; False if the lib or the AAC encoder is
    unavailable."""
    lib = get_media_lib()
    if lib is None:
        return False
    return lib.mmqg_write_test_tone_mp4(str(path).encode(), float(seconds),
                                        int(freq)) == 0


def write_test_av_mp4(path, seconds: float = 6.0, freq: int = 440, *,
                      width: int = 64, height: int = 48,
                      fps: int = 10) -> bool:
    """mp4 fixture with an AAC tone and an MPEG-4 video stream (a
    brightness ramp a frame); False if the lib or the encoders are
    unavailable."""
    lib = get_media_lib()
    if lib is None:
        return False
    return lib.mmqg_write_test_av_mp4(str(path).encode(), float(seconds),
                                      int(freq), 1, int(width), int(height),
                                      int(fps)) == 0


# ------------------------------------------------------ the host runtime

def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded host runtime (``native/mmqg_host.cpp``: the single-file
    WAV and frame loaders and the batch packer), built first if missing or
    stale; None when it cannot be built or loaded here. A concurrent first
    caller waits for the build, as with :func:`get_media_lib`."""
    global _host_lib, _host_tried
    if _host_tried:
        return _host_lib
    with _load_lock:
        if not _host_tried:
            try:
                _host_lib = _load_host_lib()
            finally:
                _host_tried = True
    return _host_lib


def _load_host_lib() -> Optional[ctypes.CDLL]:
    if not _built(HOST_SRC, HOST_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(str(HOST_LIB_PATH))
    except OSError:
        return None
    lib.mmqg_load_wav_mono.restype = ctypes.c_long
    lib.mmqg_load_wav_mono.argtypes = [
        ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int16), ctypes.c_long]
    lib.mmqg_load_frames.restype = ctypes.c_long
    lib.mmqg_load_frames.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.mmqg_pack_submit.restype = ctypes.c_void_p
    lib.mmqg_pack_submit.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int16), ctypes.c_long, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int]
    lib.mmqg_pack_wait.restype = ctypes.c_int
    lib.mmqg_pack_wait.argtypes = [ctypes.c_void_p]
    return lib


def available() -> bool:
    """Whether the host runtime is built and loaded."""
    return get_lib() is not None


def load_wav_mono(path, target_rate: int,
                  max_samples: int) -> Optional[np.ndarray]:
    """A PCM WAV file as mono int16 at ``target_rate`` (channels averaged,
    linear resampling), at most ``max_samples`` samples; None when the
    host runtime is unavailable or the file does not parse (the caller
    falls back to ``data.wav``)."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.zeros((max_samples,), np.int16)
    n = lib.mmqg_load_wav_mono(
        str(path).encode(), target_rate,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), max_samples)
    if n < 0:
        return None
    return out[:n]


def load_frames(path, t_max: int, h: int, w: int) -> Optional[np.ndarray]:
    """The first ``t_max`` frames of a uint8 (T, h, w, 3) ``.npy`` file;
    None when the host runtime is unavailable or the file is not such an
    array (the caller falls back to ``np.load``)."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.zeros((t_max, h, w, 3), np.uint8)
    n = lib.mmqg_load_frames(
        str(path).encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        t_max, h, w)
    if n < 0:
        return None
    return out[:n]


class PackHandle:
    """A batch being packed by the native pool's threads."""

    def __init__(self, lib, handle, arrays):
        self._lib = lib
        self._handle = handle
        self._arrays = arrays  # buffers and path strings, alive until wait()

    def wait(self) -> int:
        """Join the pack job; returns the number of items that failed."""
        if self._handle is None:
            return 0
        errors = self._lib.mmqg_pack_wait(ctypes.c_void_p(self._handle))
        self._handle = None
        self._arrays = None
        return errors

    def __del__(self):
        # a dropped handle still joins its threads: they write into
        # buffers the interpreter would otherwise free under them
        if self._handle is not None:
            self.wait()


def pack_batch_async(frame_paths: Sequence[Optional[str]],
                     wav_paths: Sequence[Optional[str]],
                     frames: np.ndarray, audio: np.ndarray,
                     frames_len: np.ndarray, audio_len: np.ndarray, *,
                     target_rate: int = 16000,
                     n_threads: int = 2) -> Optional[PackHandle]:
    """Start filling a batch's media slots on ``n_threads`` native threads
    (the JAX package's ``pack_batch_async``): row i's frames from
    ``frame_paths[i]`` (a uint8 (T, H, W, 3) ``.npy``) and int16 PCM at
    ``target_rate`` from ``wav_paths[i]``, None skipping the modality.
    ``frames`` (n, t_max, h, w, 3) uint8, ``audio`` (n, s_max) int16 and
    the int32 lengths are preallocated and C-contiguous. Call ``wait()``
    before reading them. None when the host runtime is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    # the C++ threads write through raw pointers with C-order strides
    for name, arr, dt in (("frames", frames, np.uint8),
                          ("audio", audio, np.int16),
                          ("frames_len", frames_len, np.int32),
                          ("audio_len", audio_len, np.int32)):
        if arr.dtype != dt or not arr.flags["C_CONTIGUOUS"]:
            raise ValueError(
                f"{name} must be C-contiguous {np.dtype(dt).name} "
                f"(got {arr.dtype}, contiguous={arr.flags['C_CONTIGUOUS']})")
    n, t_max, h, w, _ = frames.shape
    if not (len(frame_paths) == len(wav_paths) == n == audio.shape[0]
            == len(frames_len) == len(audio_len)):
        raise ValueError("one path of each kind and one buffer row per item")

    def c_paths(paths):
        arr = (ctypes.c_char_p * n)()
        keep = [None if p is None else str(p).encode() for p in paths]
        for i, b in enumerate(keep):
            arr[i] = b
        return arr, keep

    fp_arr, fp_keep = c_paths(frame_paths)
    wp_arr, wp_keep = c_paths(wav_paths)
    handle = lib.mmqg_pack_submit(
        fp_arr, wp_arr, n,
        frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), t_max, h, w,
        audio.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), audio.shape[1],
        target_rate,
        frames_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        audio_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n_threads)
    return PackHandle(lib, handle, (frames, audio, frames_len, audio_len,
                                    fp_arr, wp_arr, fp_keep, wp_keep))
