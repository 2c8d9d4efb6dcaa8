"""The port's host media prep (``mmqg_tpu_torch/data/{text_prep, subtitles,
wav, native, saliency}.py``) against the JAX package's: text
normalisation, subtitle parsing and contexts, span clipping, salient
frames byte for byte per route (native seek-decode and cv2), native span
audio PCM, and where the port builds its native media library."""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from mmqg_tpu.data import native as jnative
from mmqg_tpu.data import saliency as jsaliency
from mmqg_tpu.data import subtitles as jsubs
from mmqg_tpu.data import text_prep as jtext
from mmqg_tpu.data import wav as jwav
from mmqg_tpu_torch.data import native, saliency, subtitles, text_prep, wav
from tests.torch_port_fixtures import write_cv2_video

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent

TEXTS = [
    "I can't believe it won't work, let's see!",
    "They’re here — we’d go; I’m sure you’ll have what’s needed?",
    "state-of-the-art snake_case values: 3.14, 42 and x2...",
    "Don't stop; it's the end. Isn't it?",
    "¿Qué? naïve café — über 100% «quoted»",
    "",
    "--- ___ ;;;",
]


@pytest.mark.parametrize("text", TEXTS)
def test_text_prep_matches_jax(text):
    assert text_prep.decontract(text) == jtext.decontract(text)
    assert text_prep.tokenize(text) == jtext.tokenize(text)
    assert text_prep.preprocess_text(text) == jtext.preprocess_text(text)
    assert (text_prep.lowercase_subtitle(text + "\nLine TWO ")
            == jtext.lowercase_subtitle(text + "\nLine TWO "))


SRT = ("1\n00:00:00,000 --> 00:00:03,000\nWhat IS the process\n\n"
       "2\r\n00:00:03,000 --> 00:00:06,500\r\nthe value\nof the system\r\n\r\n"
       "3\n00:00:0x,000 --> 00:00:07,000\nmalformed cue\n\n"
       "00:01:02,250 --> 01:00:00,000\nno index line, an hour long\n")
VTT = ("WEBVTT\n\nNOTE a comment\n\n"
       "cue-1\n00:01.000 --> 00:04.000 align:start\nIt's <b>bold</b>\n\n"
       "00:00:05.500 --> 00:00:08.000\nsecond cue\n\n"
       "00:09.000 --> bad\nskipped\n")


@pytest.mark.parametrize("name,text", [("a.srt", SRT), ("b.vtt", VTT),
                                       ("c.txt", VTT), ("d.srt", "")])
def test_subtitles_match_jax(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    got = subtitles.parse_subtitle_file(path)
    ref = jsubs.parse_subtitle_file(path)
    assert [(c.start, c.end, c.text) for c in got] == [
        (c.start, c.end, c.text) for c in ref]
    assert len(got) == {"a.srt": 3, "b.vtt": 2, "c.txt": 2, "d.srt": 0}[name]
    for a, b in ((0.0, 1.0), (2.0, 4.0), (3.0, 3.0), (4.5, 5.0),
                 (62.0, 70.0), (100.0, 200.0)):
        assert (subtitles.extract_context(got, a, b)
                == jsubs.extract_context(ref, a, b)), (a, b)
        for s, e in ((1.0, 2.0), (0.0, 9.0), (4.6, 4.9)):
            assert (subtitles.is_important(a, b, s, e)
                    == jsubs.is_important(a, b, s, e))


@pytest.mark.parametrize("mmss", ["0:00", "0:45", "1:10", "12:03", "59:59"])
def test_span_seconds_match_jax(mmss):
    assert subtitles.span_seconds(mmss) == jsubs.span_seconds(mmss)
    assert (saliency.parse_span_ms(mmss, "60:00")
            == jsaliency.parse_span_ms(mmss, "60:00"))


@pytest.mark.parametrize("rate,start,end", [
    (16000, 0.0, 1.0), (16000, 1.25, 2.5), (1600, 2.0, 9.0),
    (44100, -1.0, 0.3), (16000, 2.0, 1.0), (16000, 3.1, 3.1)])
def test_clip_span_matches_jax(rate, start, end):
    x = np.arange(int(2.7 * rate), dtype=np.float32)
    got = wav.clip_span(x, rate, start, end)
    ref = jwav.clip_span(x, rate, start, end)
    assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes()


@pytest.fixture(scope="module")
def media():
    """The port's native media library, built on first use."""
    if not native.media_available() or not jnative.media_available():
        pytest.fail("the native media library does not build on this host")
    return native


SPANS_MS = [(1000, 3000), (2500, 5200), (0, 400), (5000, 9000)]


@pytest.mark.parametrize("route", ["native", "cv2"])
@pytest.mark.parametrize("frame_dim", [(32, 32), (40, 24)])
def test_salient_frames_match_jax_per_route(tmp_path, media, monkeypatch,
                                            route, frame_dim):
    """Byte-identical frames, route by route (the two routes differ from
    each other in the resize's rounding); non-square sizes take cv2 in
    both packages."""
    video = write_cv2_video(tmp_path / "v.mp4")
    if route == "cv2":
        monkeypatch.setenv("MMQG_NATIVE_FRAMES", "0")
    before = dict(saliency.frame_routes)
    got = saliency.extract_salient_frames_for_video(video, SPANS_MS,
                                                    frame_dim)
    ref = jsaliency.extract_salient_frames_for_video(video, SPANS_MS,
                                                     frame_dim)
    served = route if frame_dim[0] == frame_dim[1] else "cv2"
    assert saliency.frame_routes[served] == before[served] + 1
    assert sum(saliency.frame_routes.values()) == sum(before.values()) + 1
    assert len(got) == len(ref) == len(SPANS_MS)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype == np.uint8
        assert g.shape == r.shape and g.shape[-1] == 3
        assert g.tobytes() == r.tobytes()
    assert got[0].shape[0] >= 1 and got[1].shape[0] >= 1


def test_missing_and_corrupt_video_raise_like_jax(tmp_path, media):
    video = write_cv2_video(tmp_path / "v.mp4")
    corrupt = tmp_path / "corrupt.mp4"
    corrupt.write_bytes(video.read_bytes()[:300])
    for path in (tmp_path / "missing.mp4", corrupt):
        for fn in (saliency.extract_salient_frames_for_video,
                   jsaliency.extract_salient_frames_for_video):
            with pytest.raises(FileNotFoundError, match="cannot open"):
                fn(path, [(0, 1000)], (32, 32))


def test_native_audio_and_frames_match_jax(tmp_path, media):
    """decode_audio_spans, decode_audio, video_info and decode_frames of a
    fixture mp4 with both streams: the port's build against the JAX
    package's, byte for byte."""
    video = tmp_path / "av.mp4"
    assert native.write_test_av_mp4(video, seconds=6.0, freq=330, fps=10)
    other = tmp_path / "av_jax.mp4"
    assert jnative.write_test_av_mp4(other, seconds=6.0, freq=330, fps=10)
    tone = tmp_path / "tone.mp4"
    assert native.write_test_tone_mp4(tone, seconds=2.0, freq=500)
    spans = [(0.0, 1.0), (1.5, 4.25), (3.0, 3.5), (5.5, None)]
    for rate in (16000, 1600):
        got = native.decode_audio_spans(video, rate, spans)
        ref = jnative.decode_audio_spans(other, rate, spans)
        assert len(got) == len(ref) == len(spans)
        for g, r in zip(got, ref):
            assert g.dtype == np.int16 and g.tobytes() == r.tobytes()
            assert len(g) > 0
        one = native.decode_audio(video, rate, start=1.5, end=4.25)
        assert one.tobytes() == got[1].tobytes()
    assert (native.decode_audio(tone, 16000).tobytes()
            == jnative.decode_audio(tone, 16000).tobytes())
    assert native.video_info(video) == jnative.video_info(other)
    assert native.media_duration(video) == jnative.media_duration(other)
    for skip in (True, False):
        g = native.decode_frames(video, [12, 3, 40], 16, skip=skip)
        r = jnative.decode_frames(other, [12, 3, 40], 16, skip=skip)
        assert all(np.array_equal(a, b) for a, b in zip(g[:3], r[:3]))
        assert g[3] == r[3] and g[1].all()
    # a video without an audio stream: ValueError in both
    silent = write_cv2_video(tmp_path / "silent.mp4")
    for mod in (native, jnative):
        with pytest.raises(ValueError, match="no audio stream"):
            mod.decode_audio_spans(silent, 16000, [(0.0, 1.0)])


def test_native_build_lands_in_the_port_build_dir(tmp_path, monkeypatch,
                                                  media):
    """The library is built from native/mmqg_media.cpp into the port's
    build/native/ (a temporary name, then os.replace), leaves native/'s
    sources as they were, and is rebuilt when the source is newer."""
    assert native.MEDIA_LIB_PATH.parent == REPO / "mmqg_tpu_torch" / "build" \
        / "native"
    assert native.MEDIA_SRC == REPO / "native" / "mmqg_media.cpp"
    tracked = {p: p.stat().st_mtime_ns for p in (REPO / "native").iterdir()
               if p.suffix in (".cpp", "") and p.is_file()}
    src = tmp_path / "mmqg_media.cpp"
    src.write_bytes(native.MEDIA_SRC.read_bytes())
    build = tmp_path / "build"
    monkeypatch.setattr(native, "MEDIA_SRC", src)
    monkeypatch.setattr(native, "BUILD_DIR", build)
    monkeypatch.setattr(native, "MEDIA_LIB_PATH", build / "libmmqg_media.so")
    calls = []
    real_run = native.subprocess.run

    def run(cmd, **kw):
        calls.append(list(cmd))
        return real_run(cmd, **kw)

    monkeypatch.setattr(native.subprocess, "run", run)
    lib = build / "libmmqg_media.so"
    for src_age in (None, -100, 100):  # no library, up to date, stale
        if src_age is not None:
            t = lib.stat().st_mtime + src_age
            os.utime(src, (t, t))
        monkeypatch.setattr(native, "_media_lib", None)
        monkeypatch.setattr(native, "_media_tried", False)
        assert native.get_media_lib() is not None
    assert len(calls) == 2  # the second load found the library up to date
    for cmd in calls:
        assert cmd[0] == "g++" and str(src) in cmd
        out = Path(cmd[cmd.index("-o") + 1])
        assert out.parent == build and out.name.endswith(".tmp")
        assert "-lavformat" in cmd and "-shared" in cmd
    assert sorted(p.name for p in build.iterdir()) == ["libmmqg_media.so"]
    assert {p: p.stat().st_mtime_ns for p in tracked} == tracked


@pytest.mark.parametrize("which", ["jax", "port"])
def test_concurrent_first_use_waits_for_the_library(tmp_path, monkeypatch,
                                                    media, which):
    """Reference defect: the JAX package's loader marks the library as
    tried before it builds, so a prep thread that calls during the build
    gets None, and its video takes the cv2 route (or no audio). The port's
    second caller waits for the build and gets the library."""
    import shutil
    import threading
    import time

    mod = jnative if which == "jax" else native
    built = Path(native.MEDIA_LIB_PATH)
    target = tmp_path / "libmmqg_media.so"
    monkeypatch.setattr(mod, "_MEDIA_LIB_PATH" if which == "jax"
                        else "MEDIA_LIB_PATH", target)
    if which == "port":
        monkeypatch.setattr(native, "BUILD_DIR", tmp_path)

    def slow_build(cmd, **kw):
        time.sleep(0.6)
        out = Path(cmd[cmd.index("-o") + 1]) if "-o" in cmd else target
        shutil.copyfile(built, out)

    monkeypatch.setattr(mod.subprocess, "run", slow_build)
    monkeypatch.setattr(mod, "_media_lib", None)
    monkeypatch.setattr(mod, "_media_tried", False)
    got = {}
    threads = [threading.Thread(target=lambda k=k: got.__setitem__(
        k, mod.get_media_lib())) for k in ("first", "during the build")]
    threads[0].start()
    time.sleep(0.2)
    threads[1].start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert got["first"] is not None
    if which == "jax":
        assert got["during the build"] is None
    else:
        assert got["during the build"] is got["first"]
