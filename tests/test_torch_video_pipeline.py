"""The port's raw-video entry points (``QGPipeline.generate_from_video``,
``generate_from_videos`` per video and coalesced) against the JAX
package's, both in f32 on the CPU with the same numpy weights: the same
questions for greedy and sampling, the same job errors, the audio route
counted; and the two reference defects the port leaves out (sampling
identities past 65536 jobs, partial results of a failed coalesced batch)."""

import subprocess

import numpy as np
import pytest
import torch

from mmqg_tpu.data import native as jnative
from mmqg_tpu.data import wav as jwav
from mmqg_tpu.pipeline import QGPipeline as JaxPipeline
from mmqg_tpu_torch import pipeline as P
from mmqg_tpu_torch.data import native
from mmqg_tpu_torch.pipeline import QGPipeline
from tests.torch_port_fixtures import (caption, f32_pipelines,
                                      write_cv2_video, write_srt,
                                      write_stereo_wav)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pipes(tiny_config):
    with f32_pipelines(tiny_config) as pair:
        yield pair


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Three videos: a cv2 mp4 with a staged wav and subtitles; an mp4
    with its own audio track (the native decoder) and explicit contexts;
    a cv2 mp4 with no audio at all and subtitles. Spans in seconds and
    "M:SS", of 1-4 s, so that they fall into several AV buckets."""
    if not native.media_available() or not jnative.media_available():
        pytest.fail("the native media library does not build on this host")
    d = tmp_path_factory.mktemp("videos")
    av = d / "av.mp4"
    assert native.write_test_av_mp4(av, seconds=6.0, freq=330, fps=10)
    return [
        {"video_path": write_cv2_video(d / "a.mp4", seed=1),
         "spans": [(1.0, 3.0), ("0:03", "0:05")],
         "subtitles": write_srt(d / "a.srt", 6),
         "audio_path": write_stereo_wav(d / "a.wav", 6.0, seed=1)},
        {"video_path": av, "spans": [(0.5, 2.5), (2.0, 5.5), (4, 5)],
         "contexts": [caption(4), "", caption(9).title()]},
        {"video_path": write_cv2_video(d / "c.mp4", seed=2),
         "spans": [("0:01", "0:04")],
         "subtitles": write_srt(d / "c.srt", 6, every=2)},
    ]


def _kw(job):
    return {k: job[k] for k in ("subtitles", "contexts", "audio_path")
            if k in job}


@pytest.mark.parametrize("strategy", ["greedy", "sampling"])
def test_generate_from_video_matches_jax(pipes, jobs, strategy):
    jax_pipe, port = pipes
    kw = dict(strategy=strategy, seed=5)
    routes = []
    for job in jobs:
        before = dict(P.audio_routes)
        got = port.generate_from_video(job["video_path"], job["spans"],
                                       **_kw(job), **kw)
        ref = jax_pipe.generate_from_video(job["video_path"], job["spans"],
                                           **_kw(job), **kw)
        assert got == ref and len(got) == len(job["spans"])
        routes.append([r for r in P.audio_routes
                       if P.audio_routes[r] != before[r]])
    assert routes == [["wav"], ["native"], ["none"]]
    # the contexts, frames and audio that went in are JAX's too
    for job in jobs:
        got = port._prep_video(job["video_path"], job["spans"], **_kw(job))
        ref = jax_pipe._prep_video(job["video_path"], job["spans"],
                                   **_kw(job))
        assert got[0] == ref[0]
        for g, r in zip(got[1], ref[1]):
            assert g.tobytes() == r.tobytes()
        if ref[2] is None:
            assert got[2] is None
        else:
            for g, r in zip(got[2], ref[2]):
                assert g.dtype == r.dtype and g.tobytes() == r.tobytes()
    assert any(port._prep_video(jobs[0]["video_path"], jobs[0]["spans"],
                                subtitles=jobs[0]["subtitles"])[0])


@pytest.mark.parametrize("strategy", ["greedy", "sampling"])
@pytest.mark.parametrize("coalesce,max_coalesce", [(False, 64), (True, 64),
                                                   (True, 1)])
def test_generate_from_videos_matches_jax(pipes, jobs, strategy, coalesce,
                                          max_coalesce):
    """Port vs JAX in each mode, and the port's coalesced questions equal
    its per-video ones (each row draws from its (job, span) stream)."""
    jax_pipe, port = pipes
    kw = dict(workers=3, strategy=strategy, seed=3, coalesce=coalesce,
              max_coalesce=max_coalesce)
    times, errors = {}, {}
    got = port.generate_from_videos(jobs, completion_times=times,
                                    errors=errors, **kw)
    ref = jax_pipe.generate_from_videos(jobs, **kw)
    assert got == ref and errors == {}
    assert [len(q) for q in got] == [len(j["spans"]) for j in jobs]
    assert set(times) == {0, 1, 2}
    per_video = port.generate_from_videos(jobs, workers=2,
                                          strategy=strategy, seed=3)
    assert got == per_video
    if strategy == "sampling":
        # job 0's rows draw from identities 0, 1: generate()'s defaults
        first = port.generate_from_video(jobs[0]["video_path"],
                                         jobs[0]["spans"], **_kw(jobs[0]),
                                         strategy=strategy, seed=3)
        assert got[0] == first


def test_row_seed_equals_jax_below_the_limit():
    for job in (0, 1, 2, 255, 32767, 32768, 65534, 65535):
        for span in (0, 1, 7, 65535):
            v = QGPipeline._row_seed(job, span)
            assert v == JaxPipeline._row_seed(job, span)
            assert -2**31 <= v < 2**31
    seen = {QGPipeline._row_seed(j, s) for j in range(0, 65536, 97)
            for s in range(0, 65536, 4099)}
    assert len(seen) == len(range(0, 65536, 97)) * len(range(0, 65536, 4099))


def test_sampled_calls_past_65536_jobs_raise(pipes, monkeypatch):
    """Reference defect: ``_row_seed`` packs the job index into 16 bits, so
    JAX's job 65536 draws job 0's stream. The port refuses a sampled call
    of more than 65536 jobs up front; greedy and beam are not refused."""
    jax_pipe, port = pipes
    assert JaxPipeline._row_seed(65536, 0) == JaxPipeline._row_seed(0, 0)
    assert JaxPipeline._row_seed(65536 + 9, 3) == JaxPipeline._row_seed(9, 3)
    monkeypatch.setattr(port, "_generate_from_videos_coalesced",
                        lambda jobs, **kw: len(jobs))
    jobs = [{}] * (P.MAX_SAMPLED_JOBS + 1)
    for strategy in ("sampling", "topk", "topp"):
        with pytest.raises(ValueError, match="at most 65536 jobs"):
            port.generate_from_videos(jobs, strategy=strategy, coalesce=True)
        with pytest.raises(ValueError, match="at most 65536 jobs"):
            port.generate_from_videos(jobs, strategy=strategy)
        assert port.generate_from_videos(jobs[1:], strategy=strategy,
                                         coalesce=True) == 65536
    for strategy in ("greedy", "beam"):
        assert port.generate_from_videos(jobs, strategy=strategy,
                                         coalesce=True) == 65537


@pytest.mark.parametrize("coalesce", [False, True])
def test_job_errors_and_completion_times_match_jax(pipes, jobs, tmp_path,
                                                   coalesce):
    """A missing file, a truncated mp4 and a job without spans each fail
    alone: None in their slots, a message in ``errors``, as in JAX."""
    jax_pipe, port = pipes
    truncated = tmp_path / "trunc.mp4"
    truncated.write_bytes(jobs[1]["video_path"].read_bytes()[:200])
    mixed = [jobs[0], {"video_path": tmp_path / "missing.mp4",
                       "spans": [(0.0, 1.0)]},
             jobs[2], {"video_path": truncated, "spans": [(1.0, 3.0)]},
             {"video_path": jobs[1]["video_path"]}]
    kw = dict(workers=2, coalesce=coalesce)
    errs, jerrs, times = {}, {}, {}
    got = port.generate_from_videos(mixed, errors=errs,
                                    completion_times=times, **kw)
    ref = jax_pipe.generate_from_videos(mixed, errors=jerrs, **kw)
    assert got == ref
    assert got[1] is None and got[3] is None and got[4] is None
    assert errs == jerrs and set(errs) == {1, 3, 4}
    assert "cannot open video" in errs[1] and "KeyError" in errs[4]
    assert set(times) == {0, 2}
    with pytest.warns(RuntimeWarning, match="job 1 failed"):
        out = port.generate_from_videos(mixed[:2], **kw)
    assert out == [got[0], None]


def _failing_chunk(pipe, bad_seed):
    """``pipe.generate_async`` whose finalizer raises for a batch that
    carries the row identity ``bad_seed``."""
    real = pipe.generate_async

    def generate_async(*args, row_seeds=None, **kw):
        fin = real(*args, row_seeds=row_seeds, **kw)
        if bad_seed in list(row_seeds or ()):
            def fail():
                raise RuntimeError("device fault")
            return fail
        return fin
    return generate_async


def test_failed_coalesced_batch_returns_none(pipes, jobs, monkeypatch):
    """Reference defect: when one of a job's coalesced batches fails at
    readback, JAX records the error but returns the job's other spans as a
    partly filled list. The port returns None for every job in
    ``errors``; the other jobs' questions are unchanged."""
    jax_pipe, port = pipes
    bad = QGPipeline._row_seed(1, 0)   # job 1's first span
    kw = dict(workers=2, coalesce=True, max_coalesce=1)
    good = port.generate_from_videos(jobs, **kw)
    for pipe in (jax_pipe, port):
        monkeypatch.setattr(pipe, "generate_async", _failing_chunk(pipe, bad))
    errs, jerrs = {}, {}
    got = port.generate_from_videos(jobs, errors=errs, **kw)
    ref = jax_pipe.generate_from_videos(jobs, errors=jerrs, **kw)
    assert set(errs) == set(jerrs) == {1} and "device fault" in errs[1]
    assert ref[1][0] is None and ref[1][1:] == good[1][1:]  # partial list
    assert got[1] is None
    assert got[0] == ref[0] == good[0] and got[2] == ref[2] == good[2]


@pytest.mark.parametrize("route", ["native", "ffmpeg", "none"])
def test_span_audio_routes_match_jax(pipes, jobs, tmp_path, monkeypatch,
                                     route):
    """The span audio of a video with its own track, by each route: the
    native decoder; the ffmpeg binary when the decoder is missing (a
    stand-in binary that writes a wav); none when neither is there. The
    same PCM as JAX's, and the route counted."""
    import shutil

    jax_pipe, port = pipes
    video = jobs[1]["video_path"]
    spans = [(0.5, 2.5), (3.0, 3.25)]
    if route != "native":
        for mod in (native, jnative):
            monkeypatch.setattr(mod, "media_available", lambda: False)
    if route == "ffmpeg":
        rate = port.mc.sample_rate
        pcm = (np.sin(np.arange(6 * rate) / 9.0) * 0.4).astype(np.float32)
        real_run = subprocess.run

        def fake_ffmpeg(cmd, **kw):
            if cmd[0] != "ffmpeg":
                return real_run(cmd, **kw)
            assert cmd[cmd.index("-ar") + 1] == str(rate)
            jwav.write_wav(cmd[-1], pcm, rate)
            return subprocess.CompletedProcess(cmd, 0)

        monkeypatch.setattr(shutil, "which",
                            lambda name: "/bin/ffmpeg" if name == "ffmpeg"
                            else None)
        monkeypatch.setattr(subprocess, "run", fake_ffmpeg)
    else:
        monkeypatch.setattr(shutil, "which", lambda name: None)
    before = dict(P.audio_routes)
    got = port._span_audio(video, spans)
    ref = jax_pipe._span_audio(video, spans)
    assert P.audio_routes[route] == before[route] + 1
    assert sum(P.audio_routes.values()) == sum(before.values()) + 1
    if route == "none":
        assert got is None and ref is None
        return
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.tobytes() == r.tobytes()
        assert len(g) > 0
