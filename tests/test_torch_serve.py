"""The port's JSONL serving daemon (``mmqg_tpu_torch/serve.py``): the same
answers as the JAX package's ``serve()`` on the same requests (staged and
raw-video, greedy and sampling, both pipelines in f32 on the CPU); the
daemon's semantics (bad requests error alone, bucket-grouped batches,
backlog batching at zero linger, sampling independent of batching, the
graceful stop); the two reference defects the port leaves out (no
back-pressure on stdin, responses written on the dispatch loop); and
``python -m mmqg_tpu_torch.serve`` as a process."""

import io
import json
import os
import queue
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import mmqg_tpu.serve as jserve
from mmqg_tpu.data import native as jnative
from mmqg_tpu_torch import checkpoint as ckpt
from mmqg_tpu_torch import pipeline as P
from mmqg_tpu_torch import serve as S
from mmqg_tpu_torch.data import native
from tests.torch_port_fixtures import (WORDS, caption, f32_pipelines,
                                       tiny_model, write_cv2_video,
                                       write_srt, write_stereo_wav)

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def pipes(tiny_config):
    with f32_pipelines(tiny_config) as pair:
        yield pair


@pytest.fixture(scope="module")
def media(tmp_path_factory, tiny_config):
    """Staged media (frames .npy at two lengths, a wav, a frames file of
    the wrong geometry) and a lecture mp4 with its own audio track, and
    one without, with subtitles."""
    if not native.media_available() or not jnative.media_available():
        pytest.fail("the native media library does not build on this host")
    d = tmp_path_factory.mktemp("serve_media")
    rng = np.random.RandomState(0)
    fs = tiny_config.frame_size
    paths = {}
    for name, t in (("short", 1), ("long", 3)):
        paths[name] = d / f"{name}.npy"
        np.save(paths[name], rng.randint(0, 256, (t, fs, fs, 3), np.uint8))
    paths["wrong"] = d / "wrong.npy"
    np.save(paths["wrong"], np.zeros((2, 64, 64, 3), np.uint8))
    paths["wav"] = write_stereo_wav(d / "a.wav", 2.5, seed=3)
    paths["av"] = d / "av.mp4"
    assert native.write_test_av_mp4(paths["av"], seconds=6.0, freq=330,
                                    fps=10)
    paths["silent"] = write_cv2_video(d / "silent.mp4", seed=4)
    paths["srt"] = write_srt(d / "a.srt", 6)
    return {k: str(v) for k, v in paths.items()}


def _requests(media):
    """Eight requests: staged media, raw video (with its own audio, or
    none, with subtitles or a context), text only."""
    return [
        {"id": 0, "context": caption(1), "frames_npy": media["long"],
         "audio_wav": media["wav"]},
        {"id": "v1", "video": media["av"], "span": ["0:01", "0:03"],
         "subtitles": media["srt"]},
        {"id": 2, "context": caption(2)},
        {"id": "v3", "video": media["silent"], "span": [0.5, 4.0],
         "subtitles": media["srt"]},
        {"id": 4, "context": caption(5), "frames_npy": media["short"]},
        {"id": "v5", "video": media["av"], "span": [2, 5.5],
         "context": caption(7)},
        {"id": 6, "context": caption(3), "audio_wav": media["wav"]},
        {"id": "v7", "video": media["silent"], "span": ["0:00", "0:02"],
         "audio_wav": media["wav"]},
    ]


def _lines(reqs) -> str:
    return "".join(json.dumps(r) + "\n" for r in reqs)


def _run(serve_fn, pipe, reqs, **kw):
    out = io.StringIO()
    kw = dict(dict(strategy="greedy", max_batch=8, linger_ms=200.0), **kw)
    n = serve_fn(pipe, inp=io.StringIO(reqs if isinstance(reqs, str)
                                       else _lines(reqs)), out=out, **kw)
    return n, [json.loads(line) for line in out.getvalue().splitlines()]


@pytest.mark.parametrize("strategy", ["greedy", "sampling"])
def test_serve_answers_equal_jax(pipes, media, strategy):
    jax_pipe, port = pipes
    reqs = _requests(media)
    before = dict(P.audio_routes)
    n, got = _run(S.serve, port, reqs, strategy=strategy, seed=9)
    routes = {k: P.audio_routes[k] - before[k] for k in before}
    jn, ref = _run(jserve.serve, jax_pipe, reqs, strategy=strategy, seed=9)
    assert n == jn == 8
    assert {r["id"]: r["question"] for r in got} == {
        r["id"]: r["question"] for r in ref}
    assert sorted(map(str, (r["id"] for r in got))) == sorted(
        str(r["id"]) for r in reqs)
    assert all(r["latency_ms"] > 0 and r["batch_size"] >= 1 for r in got)
    # two raw videos with their own track, one without, three staged wavs
    assert routes == {"native": 2, "ffmpeg": 0, "wav": 3, "none": 1}


def test_serve_malformed_line_and_bad_media(pipes, media):
    _, port = pipes
    text = ('{"id": 1, "context": "xab xac"}\nnot json\n'
            + json.dumps({"id": 3, "frames_npy": "/nonexistent.npy"}) + "\n"
            + json.dumps({"id": 4, "video": media["av"]}) + "\n")
    n, responses = _run(S.serve, port, text, bucket_group=False)
    assert n == 4 and len(responses) == 4
    by_id = {r["id"]: r for r in responses}
    assert "question" in by_id[1] and by_id[1]["batch_size"] == 1
    assert "error" in by_id[None] and "error" in by_id[3]
    assert "error" in by_id[4]  # a video request without a span


def test_serve_poisoned_batch_isolates_request(pipes, media):
    """A request whose media loads but breaks batch packing errors alone
    (per-request fallback); its companions answer."""
    _, port = pipes
    reqs = [{"id": "good", "context": caption(1)},
            {"id": "poison", "context": caption(2),
             "frames_npy": media["wrong"]},
            {"id": "good2", "context": caption(3)}]
    n, responses = _run(S.serve, port, reqs, bucket_group=False)
    by_id = {r["id"]: r for r in responses}
    assert n == 3 and len(responses) == 3
    assert "question" in by_id["good"] and "question" in by_id["good2"]
    assert "error" in by_id["poison"]
    alone = port.generate([caption(1)], row_seeds=[0])[0]
    assert by_id["good"]["question"] == alone


def test_serve_bucket_groups_split_mixed_av(pipes, media):
    _, port = pipes
    reqs = [{"id": "s1", "context": caption(1), "frames_npy": media["short"]},
            {"id": "s2", "context": caption(2), "frames_npy": media["short"]},
            {"id": "lg", "context": caption(3), "frames_npy": media["long"]}]
    n, responses = _run(S.serve, port, reqs, linger_ms=300.0)
    by_id = {r["id"]: r for r in responses}
    assert n == 3 and all("question" in r for r in responses)
    assert (port.av_bucket_key(np.load(media["short"]), None)
            != port.av_bucket_key(np.load(media["long"]), None))
    assert by_id["s1"]["batch_size"] == by_id["s2"]["batch_size"] == 2
    assert by_id["lg"]["batch_size"] == 1
    _, one = _run(S.serve, port, reqs, linger_ms=300.0, bucket_group=False)
    assert {r["batch_size"] for r in one} == {3}


def test_serve_zero_linger_batches_backlog(pipes):
    _, port = pipes
    reqs = [{"id": i, "context": caption(i)} for i in range(32)]
    n, responses = _run(S.serve, port, reqs, linger_ms=0.0)
    assert n == 32 and sorted(r["id"] for r in responses) == list(range(32))
    assert max(r["batch_size"] for r in responses) >= 2


@pytest.mark.parametrize("strategy", ["sampling", "topp"])
def test_serve_sampling_reproducible_across_batching(pipes, strategy):
    """A request's draw is keyed by (seed, arrival index), not by the
    batch it rode in."""
    _, port = pipes
    reqs = [{"id": i, "context": caption(i % 3)} for i in range(6)]
    runs = [{r["id"]: r["question"] for r in _run(
        S.serve, port, reqs, strategy=strategy, seed=11, max_batch=mb,
        linger_ms=lg, top_p=0.8)[1]} for mb, lg in ((8, 300.0), (2, 0.0))]
    assert runs[0] == runs[1] and len(runs[0]) == 6
    assert len(set(runs[0].values())) > 1


class OpenEndedInput:
    """Yields fed lines and blocks when there are none (an open stdin)."""

    def __init__(self):
        self.fed: "queue.Queue" = queue.Queue()
        self.taken = 0

    def __iter__(self):
        while True:
            item = self.fed.get()
            if item is None:
                return
            self.taken += 1
            yield item


def test_serve_graceful_stop_drains_backlog(pipes):
    _, port = pipes
    inp, out, stop, result = OpenEndedInput(), io.StringIO(), \
        threading.Event(), {}

    def run():
        result["n"] = S.serve(port, strategy="greedy", max_batch=8,
                              linger_ms=10, inp=inp, out=out, stop=stop)

    t = threading.Thread(target=run)
    t.start()
    inp.fed.put(json.dumps({"id": 1, "context": caption(1)}))
    inp.fed.put(json.dumps({"id": 2, "context": caption(2)}))
    deadline = time.time() + 60
    while time.time() < deadline and out.getvalue().count('"question"') < 2:
        time.sleep(0.02)
    assert out.getvalue().count('"question"') == 2, out.getvalue()
    stop.set()
    t.join(timeout=60)
    alive = t.is_alive()
    inp.fed.put(None)
    assert not alive and result["n"] == 2


def test_serve_slow_prep_does_not_block_companions(pipes, monkeypatch):
    _, port = pipes
    real_load = S._load_media

    def load(req, p):
        if req.get("slow"):
            time.sleep(1.0)
        return real_load(req, p)

    monkeypatch.setattr(S, "_load_media", load)
    reqs = [{"id": "slow", "context": caption(1), "slow": True}] + [
        {"id": f"fast{i}", "context": caption(2)} for i in range(3)]
    n, responses = _run(S.serve, port, reqs, linger_ms=30.0,
                        prep_workers=2)
    assert n == 4 and [r["id"] for r in responses][-1] == "slow"


def _gated_load(module, monkeypatch, gate: threading.Event):
    real_load = module._load_media

    def load(req, p):
        gate.wait(30)
        return real_load(req, p)

    monkeypatch.setattr(module, "_load_media", load)


@pytest.mark.parametrize("which", ["jax", "port"])
def test_serve_backpressure_bounds_outstanding_preps(pipes, monkeypatch,
                                                     which):
    """Reference defect: JAX's feeder submits every request to the prep
    pool's unbounded queue, so while preps are stuck it reads all of stdin.
    The port stops reading once 8 * max_batch preps are outstanding (plus
    the bounded parse queue and the reader's one in hand)."""
    jax_pipe, port = pipes
    module, pipe = (jserve, jax_pipe) if which == "jax" else (S, port)
    gate = threading.Event()
    _gated_load(module, monkeypatch, gate)
    max_batch, n_req = 2, 60
    inp, out, result = OpenEndedInput(), io.StringIO(), {}
    for i in range(n_req):
        inp.fed.put(json.dumps({"id": i, "context": caption(i)}))
    inp.fed.put(None)

    def run():
        result["n"] = module.serve(pipe, strategy="greedy",
                                   max_batch=max_batch, linger_ms=0.0,
                                   inp=inp, out=out, prep_workers=2)

    t = threading.Thread(target=run)
    t.start()
    try:
        # JAX reads everything; the port stops at its bound and stays
        deadline = time.time() + (20 if which == "jax" else 1.5)
        while time.time() < deadline and inp.taken < n_req:
            time.sleep(0.02)
        taken = inp.taken
    finally:
        gate.set()
        t.join(timeout=120)
    assert not t.is_alive() and result["n"] == n_req
    ids = [json.loads(line)["id"] for line in out.getvalue().splitlines()]
    assert sorted(ids) == list(range(n_req))
    bound = 8 * max_batch + 8 * max_batch + 2  # preps + parse queue + reader
    if which == "jax":
        assert taken == n_req
    else:
        assert taken <= bound < n_req


class StalledOut:
    """An output whose first write blocks until released (a client that
    stopped reading)."""

    def __init__(self):
        self.release = threading.Event()
        self.lines = []

    def write(self, s):
        self.release.wait(60)
        self.lines += [json.loads(line) for line in s.splitlines()]

    def flush(self):
        pass


@pytest.mark.parametrize("which", ["jax", "port"])
def test_stalled_reader_does_not_stall_batching(pipes, monkeypatch, which):
    """Reference defect: JAX writes responses on the dispatch loop, so a
    client that stops reading stops batching. In the port one writer
    thread owns the output: every batch is dispatched while the first
    write is blocked, and the responses then arrive in order, with their
    fields."""
    jax_pipe, port = pipes
    module, pipe = (jserve, jax_pipe) if which == "jax" else (S, port)
    dispatched = []
    real = pipe.generate_async

    def counting(*a, **kw):
        dispatched.append(len(a[0]))
        return real(*a, **kw)

    monkeypatch.setattr(pipe, "generate_async", counting)
    reqs = [{"id": i, "context": caption(i)} for i in range(8)]
    out, result = StalledOut(), {}

    def run():
        result["n"] = module.serve(pipe, strategy="greedy", max_batch=2,
                                   linger_ms=0.0, inp=io.StringIO(
                                       _lines(reqs)), out=out,
                                   prep_workers=1)

    t = threading.Thread(target=run)
    t.start()
    try:
        deadline = time.time() + (30 if which == "port" else 1.5)
        while time.time() < deadline and sum(dispatched) < 8:
            time.sleep(0.02)
        stalled_at = sum(dispatched)
    finally:
        out.release.set()
        t.join(timeout=60)
    assert not t.is_alive() and result["n"] == 8
    assert sorted(r["id"] for r in out.lines) == list(range(8))
    assert all(set(r) == {"id", "question", "batch_size", "latency_ms"}
               for r in out.lines)
    if which == "jax":
        assert stalled_at < 8
    else:
        assert stalled_at == 8
        # read back and written in dispatch order
        assert [r["id"] for r in out.lines] == list(range(8))


@pytest.fixture(scope="module")
def saved(tiny_config, tmp_path_factory):
    """A port checkpoint of the tiny model, its config.json and vocab."""
    root = tmp_path_factory.mktemp("serve_ckpt")
    cfg = tiny_config.replace(output_path=root / "results",
                              data_path=root / "data").ensure_dirs()
    with open(cfg.vocab_file, "w") as f:
        json.dump({w: i for i, w in enumerate(WORDS)}, f)
    with open(cfg.index_to_word_file, "w") as f:
        json.dump({str(i): w for i, w in enumerate(WORDS)}, f)
    _, params, state = tiny_model(cfg, n_vocab=len(WORDS), seed=4)
    params["decoder"]["attn"] = dict(params["decoder"]["attn"]._asdict())
    ckpt.save_checkpoint(cfg.checkpoint_dir, "best",
                         {"params": params, "model_state": state,
                          "step": np.zeros((), np.int32)})
    return cfg, cfg.save(root / "config.json")


def test_serve_as_a_process_on_the_cpu(saved, media):
    cfg, path = saved
    reqs = [{"id": i, "context": caption(i)} for i in range(5)] + [
        {"id": "v", "video": media["av"], "span": [1, 3],
         "subtitles": media["srt"]}]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "mmqg_tpu_torch.serve", "-c", str(path),
         "--best", "-s", "greedy", "--device", "cpu", "--linger-ms", "50"],
        input=_lines(reqs), capture_output=True, text=True, timeout=300,
        cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr
    assert "ready alias=best strategy=greedy" in proc.stderr
    assert "served 6 requests" in proc.stderr
    responses = [json.loads(line) for line in proc.stdout.splitlines()]
    assert sorted(map(str, (r["id"] for r in responses))) == sorted(
        str(r["id"]) for r in reqs)
    assert all("question" in r for r in responses)


@pytest.mark.parametrize("argv,error,match", [
    ([], RuntimeError, "no CUDA device"),
    (["--device", "cuda:0"], RuntimeError, "no CUDA device"),
    (["--device", "cpu", "--mode", "text", "--data-parallel"], None,
     "only one device is visible"),
    (["--device", "cpu", "--mode", "text"], None, "ready alias=best"),
    (["--device", "cpu", "--decoder", "non_attn"], ValueError,
     "decoder='non_attn'"),
])
def test_main_needs_the_card_unless_asked_and_refuses_what_is_not_ported(
        saved, argv, error, match, monkeypatch, capsys):
    """Without --device the daemon needs the card; --data-parallel with
    one device warns and serves on it. Every mode and decoder is ported:
    --mode text serves the tri-modal
    checkpoint's text encoder and decoder (the answers of the port's text
    pipeline, whose JAX parity is checked here in f32 too), and --decoder
    non_attn refuses parameters of the attention decoder."""
    cfg, path = saved
    assert not torch.cuda.is_available()
    argv = ["-c", str(path), "--best", "-s", "greedy"] + argv
    if error is not None:
        with pytest.raises(error, match=match):
            S.main(argv)
        return
    reqs = [{"id": i, "context": caption(i)} for i in range(3)]
    monkeypatch.setattr(sys, "stdin", io.StringIO(_lines(reqs)))
    S.main(argv)
    out, err = capsys.readouterr()
    assert match in err and "served 3 requests" in err
    got = {r["id"]: r["question"] for r in map(json.loads, out.splitlines())}
    contexts = [r["context"] for r in reqs]
    pipe = P.QGPipeline.from_checkpoint(cfg, mode="text", device="cpu")
    assert [got[i] for i in range(3)] == pipe.generate(contexts)
    with f32_pipelines(cfg) as (jax_pipe, port):
        jax_pipe.mc = jax_pipe.mc._replace(mode="text")
        port.mc = port.mc._replace(mode="text")
        assert port.generate(contexts) == jax_pipe.generate(contexts)
