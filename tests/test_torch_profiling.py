"""The port's observability: ``utils/profiling.py`` (trace, annotate,
nan_debugging, StepTimer, param_mem_mb, device_memory_report),
``utils/audit.py`` and ``utils/plotting.py`` against the JAX package's
functions, ``Trainer(profile_dir=)`` and the train CLI's ``--nan-debug``,
on the CPU at the tiny size."""

import json
import re
import shutil

import numpy as np
import pytest
import torch

from mmqg_tpu_torch.utils import audit, plotting, profiling

torch.set_num_threads(1)


def _tiny_text(tiny_config, tmp_path, **kw):
    """A port Config (mode text) writing under ``tmp_path``, its splits,
    ModelConfig and embedding matrix."""
    from mmqg_tpu_torch.config import Config
    from mmqg_tpu_torch.data.dataset import QGDataset
    from mmqg_tpu_torch.models import qg_model as TQ

    cfg = Config.load(tiny_config.save(tmp_path / "c.json")).replace(
        output_path=tmp_path / "out", **kw)
    cfg.ensure_dirs()
    train_ds = QGDataset(cfg, cfg.train_file, load_media=False)
    val_ds = QGDataset(cfg, cfg.val_file, load_media=False)
    mc = TQ.ModelConfig.from_config(cfg, n_vocab=len(train_ds.vocab),
                                    mode="text")
    emb = np.load(cfg.weights_matrix_file).astype(np.float32)
    return cfg, train_ds, val_ds, mc, emb


def _events(profile_dir):
    traces = list(profile_dir.glob("trace_*.json"))
    assert len(traces) == 1, traces
    return json.loads(traces[0].read_text())["traceEvents"]


def test_trainer_profile_dir_traces_one_warm_step(tiny_config, tiny_corpus,
                                                  tmp_path):
    """Mode text (one step variant): batch 0 runs the variant once, batch
    1 is traced inside ``annotate("train_step")``, and the trace holds
    that region, the step's spans from its H2D to its loss read and its
    ops (the K4 autograd Function's forward, whose plain version runs on
    the CPU)."""
    from mmqg_tpu_torch.train import Trainer

    cfg, train_ds, val_ds, mc, emb = _tiny_text(tiny_config, tmp_path)
    assert len(train_ds) > cfg.batch_size       # at least two batches
    logs = []
    tr = Trainer(cfg, mc, emb, train_ds, val_ds, device="cpu",
                 log_fn=logs.append, profile_dir=tmp_path / "trace")
    tr.fit(1)
    assert tr._profiled and not any("warning" in m for m in logs)
    names = {e.get("name") for e in _events(tmp_path / "trace")}
    assert {"train_step", "train.h2d", "train.loss_read"} <= names
    assert any(n and n.startswith("aten::") for n in names)
    assert "_LSTMLayerTrain" in names


def test_trainer_warns_when_no_step_was_warm(tiny_config, tiny_corpus,
                                             tmp_path):
    """One batch an epoch: no variant runs twice, nothing is traced, and
    the JAX Trainer's warning is logged."""
    from mmqg_tpu_torch.train import Trainer

    cfg, train_ds, val_ds, mc, emb = _tiny_text(tiny_config, tmp_path,
                                                batch_size=64)
    logs = []
    tr = Trainer(cfg, mc, emb, train_ds, val_ds, device="cpu",
                 log_fn=logs.append, profile_dir=tmp_path / "trace")
    tr.fit(1)
    assert not tr._profiled
    assert any(m.startswith("warning: --profile-dir set but no warm step")
               for m in logs)
    assert not (tmp_path / "trace").exists()


def test_trace_and_annotate_outside_the_trainer(tmp_path):
    @profiling.annotate("decorated")
    def f(x):
        return x * 2

    with profiling.trace(tmp_path) as prof:
        with profiling.annotate("region"):
            f(torch.ones(3)).sum()
    names = {e.get("name") for e in _events(tmp_path)}
    assert {"region", "decorated"} <= names
    assert any(e.name == "region" for e in prof.events())


def test_annotate_opens_a_range_only_while_a_profiler_records(monkeypatch):
    """With no profiler recording no range opens; under one, each entry
    opens one, in a function decorated before the profiler started too."""
    from torch.profiler import ProfilerActivity, profile

    opened = []

    class Range:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return None

    @profiling.annotate("decorated")
    def f(x):
        return x + 1

    monkeypatch.setattr(profiling, "_range", Range)
    with profiling.annotate("region"):
        assert f(1) == 2
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.annotate("region"):
            f(1)
            f(2)
        f(3)
    assert opened == ["region", "decorated", "decorated", "decorated"]
    with profiling.annotate("region"):
        f(1)
    assert len(opened) == 4


def test_annotate_spans_are_host_ranges_of_the_profiler():
    """The spans arrive among the profiler's events, one per entry, as host
    ranges at function scope: not user annotations, which the profiler
    would mirror onto the card's stream as device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    @profiling.annotate("decorated")
    def f(x):
        return x * 2

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with profiling.annotate("region"):
                f(torch.ones(3))
    mine = [e for e in prof.events() if e.name in ("region", "decorated")]
    assert sorted(e.name for e in mine) == ["decorated"] * 3 + ["region"] * 3
    assert all(e.device_type == DeviceType.CPU and not e.is_user_annotation
               for e in mine)
    regions = sorted((e.time_range.start, e.time_range.end)
                     for e in mine if e.name == "region")
    for e in mine:
        if e.name == "decorated":
            assert any(s <= e.time_range.start and e.time_range.end <= t
                       for s, t in regions)


SERVE_SPANS = ("serve.pack", "serve.h2d", "model.encode", "model.decode",
               "serve.readback")
TRAIN_SPANS = ("data.batch", "train.h2d", "train.forward", "train.backward",
               "train.optimizer", "train.loss_read")


def _tiny_pipeline(video_encoder="conv_lstm"):
    """A tiny f32 QGPipeline on the CPU and a request of three examples
    with frames and audio."""
    from mmqg_tpu_torch.models.qg_model import ModelConfig, init_params
    from mmqg_tpu_torch.pipeline import QGPipeline

    mc = ModelConfig(n_vocab=30, word_emb_dim=8, hidden_dim=16, text_layers=2,
                     dec_layers=2, video_hidden_dim=16, audio_emb_dim=8,
                     flatten_dim=10, context_max_length=12, av_max_length=4,
                     target_steps=5, frame_size=32, mel_frames=16,
                     mel_bins=16, sample_rate=1600, stft_window=64,
                     stft_hop=32, video_encoder=video_encoder)
    params, state = init_params(mc, seed=0)
    words = ["<pad>", "<start>", "<end>"] + [f"w{i}" for i in range(3, 30)]
    vocab = {w: i for i, w in enumerate(words)}
    i2w = {str(i): w for i, w in enumerate(words)}
    pipe = QGPipeline(None, mc, params, state, vocab, i2w, device="cpu",
                      dtype=torch.float32)
    rng = np.random.RandomState(3)
    contexts = [" ".join(words[3 + (i * 5 + j) % 27] for j in range(3 + i))
                for i in range(3)]
    frames = [rng.randint(0, 255, (1 + i, 32, 32, 3)).astype(np.uint8)
              for i in range(3)]
    audio = [rng.randint(-3000, 3000, 1600 * (1 + i)).astype(np.int16)
             for i in range(3)]
    return pipe, (contexts, frames, audio)


def _spans(prof, names):
    """(name, start, end) of the profiler's events named in ``names``, in
    the order they opened."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name in names),
                  key=lambda x: x[1])


@pytest.mark.parametrize("strategy", ["greedy", "beam"])
def test_generate_records_the_serving_spans_in_order(strategy, tmp_path):
    """One generate() under ``profiling.trace`` records each serving span
    once, in the order the call runs them, none overlapping the next."""
    pipe, req = _tiny_pipeline()
    pipe.generate(*req, strategy=strategy, beam_size=2)
    with profiling.trace(tmp_path) as prof:
        questions = pipe.generate(*req, strategy=strategy, beam_size=2)
    assert len(questions) == 3
    got = _spans(prof, SERVE_SPANS)
    assert [n for n, _, _ in got] == list(SERVE_SPANS)
    assert all(end <= nxt for (_, _, end), (_, nxt, _) in zip(got, got[1:]))


@pytest.mark.parametrize("video_encoder", ["conv_lstm", "resnet"])
def test_video_spans_open_only_on_the_resnet_branch(video_encoder, tmp_path):
    """``video.prepare`` then ``video.trunk``, once each inside
    ``model.encode``, where R(2+1)D encodes the frames; neither with the
    conv pyramid."""
    pipe, req = _tiny_pipeline(video_encoder)
    pipe.generate(*req)
    with profiling.trace(tmp_path) as prof:
        pipe.generate(*req)
    got = _spans(prof, ("model.encode", "video.prepare", "video.trunk"))
    if video_encoder == "conv_lstm":
        assert [n for n, _, _ in got] == ["model.encode"]
        return
    assert [n for n, _, _ in got] == ["model.encode", "video.prepare",
                                      "video.trunk"]
    (_, s0, e0), (_, s1, e1), (_, s2, e2) = got
    assert s0 <= s1 <= e1 <= s2 <= e2 <= e0


def test_a_trunk_counts_its_convs_and_weight_casts(monkeypatch):
    """``video_resnet.convs``: one inference trunk at torchvision's widths
    launches 37 convs, all with channels a multiple of 8, 14 of them
    padded to it (3 -> 45, 45 -> 64 and the four around each of 230, 460,
    921 midplanes); ``weight_casts``: each conv casts its weight once, in
    the compute dtype at the padded widths."""
    from mmqg_tpu_torch.models import video_resnet as R

    params, state = R.init_numpy(np.random.RandomState(0))
    model = R.build(params, state, torch.tensor)
    convs = {"trunks": 0, "aligned": 0, "unaligned": 0, "padded": 0}
    casts = {"calls": 0, "bytes": 0}
    monkeypatch.setattr(R, "convs", convs)
    monkeypatch.setattr(R, "weight_casts", casts)
    model.temporal(torch.zeros((1, 3, 16, 16, 3)), dtype=torch.bfloat16)
    shapes = [m.w.shape for m in model.modules() if isinstance(m, R.Conv3d)]
    assert convs == {"trunks": 1, "aligned": 37, "unaligned": 0,
                     "padded": 14}
    assert casts == {"calls": 37,
                     "bytes": 2 * sum(kt * kh * kw * R._up8(i) * R._up8(o)
                                      for kt, kh, kw, i, o in shapes)}


R2PLUS1D_READERS = ("r2plus1d_mfu.serve", "r2plus1d_roofline.serve",
                    "r2plus1d_unaligned_convs.serve",
                    "r2plus1d_cast_mb.serve", "video_trunk_enqueue_ms.serve")


@pytest.mark.parametrize("metric", R2PLUS1D_READERS)
def test_r2plus1d_readers_read_nothing_without_their_sources(metric,
                                                             monkeypatch):
    """The R(2+1)D cell's readers return None on a trace with no spans,
    kernels or calls and for a program without the counters (the parent
    commit's), and do not raise."""
    from mmqg_tpu_torch.models import video_resnet as R
    from portbench import run, trace

    reader = run.load_module(run.HERE / "metrics" / f"{metric}.py")
    monkeypatch.delattr(R, "convs")
    monkeypatch.delattr(R, "weight_casts")
    assert reader.read({"trace": trace.Trace(1.0), "cfg": {},
                        "calls": []}) is None


@pytest.mark.parametrize("accum", [1, 2])
def test_trainer_steps_record_the_training_spans(accum, tiny_config,
                                                 tiny_corpus, tmp_path):
    """An epoch of ``run_epoch`` under ``profiling.trace``: per step one
    batch gather, H2D, optimizer and loss read, and a forward and a
    backward per microbatch; each step's spans in the order it runs
    them."""
    from mmqg_tpu_torch.train import Trainer

    cfg, train_ds, val_ds, mc, emb = _tiny_text(tiny_config, tmp_path,
                                                grad_accum_steps=accum)
    tr = Trainer(cfg, mc, emb, train_ds, val_ds, device="cpu",
                 log_fn=lambda *a: None)
    steps = train_ds.num_batches(cfg.batch_size)
    with profiling.trace(tmp_path / "trace") as prof:
        tr.run_epoch(0)
    got = _spans(prof, TRAIN_SPANS)
    counts = {n: sum(g[0] == n for g in got) for n in TRAIN_SPANS}
    assert counts == {"data.batch": steps, "train.h2d": steps,
                      "train.forward": steps * accum,
                      "train.backward": steps * accum,
                      "train.optimizer": steps, "train.loss_read": steps}
    first = [n for n, _, _ in got][:3 + 2 * accum]
    assert first == (["data.batch", "train.h2d"]
                     + ["train.forward", "train.backward"] * accum
                     + ["train.optimizer"])


@pytest.mark.parametrize("path", ["serve", "train"])
def test_h2d_counters_count_the_shipped_bytes(path, monkeypatch):
    """``pipeline.h2d_shipped`` and ``train.h2d_shipped`` count the calls
    of their H2D and the ``nbytes`` of the arrays each shipped."""
    from mmqg_tpu_torch import pipeline as PL
    from mmqg_tpu_torch import train as TR

    if path == "serve":
        pipe, req = _tiny_pipeline()
        host = pipe._pack(*req)
        keys = ("context_ids", "context_len", "frames", "frames_len",
                "audio_pcm", "audio_len")
        want = sum(host[k].nbytes for k in keys)
        counter = {"calls": 0, "bytes": 0}
        monkeypatch.setattr(PL, "h2d_shipped", counter)
        pipe.generate(*req)
        pipe.generate(*req)
    else:
        rng = np.random.RandomState(0)
        arrays = {"frames": rng.randint(0, 255, (2, 3, 4, 4, 3)).astype(
                      np.uint8),
                  "audio_pcm": rng.randint(-9, 9, (2, 50)).astype(np.int16),
                  "target_ids": np.zeros((2, 5), np.int32),
                  "valid": np.ones(2, bool)}
        want = sum(v.nbytes for v in arrays.values())
        counter = {"calls": 0, "bytes": 0}
        monkeypatch.setattr(TR, "h2d_shipped", counter)
        shipped = TR.to_device(arrays, "cpu")
        TR.to_device(arrays, "cpu")
        assert sum(t.numel() * t.element_size()
                   for t in shipped.values()) == want
    assert counter == {"calls": 2, "bytes": 2 * want}


def test_cpu_pipeline_counts_pageable_h2d(monkeypatch):
    """``pipeline.h2d_staged``: a CPU pipeline packs into new numpy arrays
    and ships every ``_to_device`` call pageable, allocating no staging;
    ``h2d_shipped`` counts the same calls."""
    from mmqg_tpu_torch import pipeline as PL

    pipe, req = _tiny_pipeline()
    staged = {"pinned": 0, "pageable": 0, "allocated": 0}
    shipped = {"calls": 0, "bytes": 0}
    monkeypatch.setattr(PL, "h2d_staged", staged)
    monkeypatch.setattr(PL, "h2d_shipped", shipped)
    pipe.generate(*req)
    pipe.generate_async(*req, strategy="beam", beam_size=2)()
    host = pipe._pack(*req)
    pipe._to_device(host)
    assert pipe._staging is None
    assert all(v.base is None for v in host.values())
    assert staged == {"pinned": 0, "pageable": 3, "allocated": 0}
    assert shipped["calls"] == 3


def _nan_model():
    from mmqg_tpu_torch.compat.from_jax import params_from_numpy
    from mmqg_tpu_torch.models import qg_model as TQ

    mc = TQ.ModelConfig(n_vocab=12, word_emb_dim=4, hidden_dim=8,
                        text_layers=1, dec_layers=1, video_hidden_dim=8,
                        audio_emb_dim=4, context_max_length=5,
                        av_max_length=2, target_steps=3, mode="text",
                        dropout=0.0, text_dropout=0.0)
    params, state = TQ.init_params(mc, 1)
    rng = np.random.RandomState(0)
    batch = {"context_ids": torch.tensor(rng.randint(3, 12, (2, 5)),
                                         dtype=torch.int32),
             "context_len": torch.tensor([5, 3], dtype=torch.int32),
             "target_ids": torch.tensor(rng.randint(3, 12, (2, 3)),
                                        dtype=torch.int32),
             "target_len": torch.tensor([3, 2], dtype=torch.int32)}
    return mc, params_from_numpy(params, state, "cpu", trainable=True), batch


@pytest.mark.parametrize("where,named", [
    ("text_enc", "mmqg_tpu_torch.ops.lstm_train._LSTMLayerTrain"),
    ("decoder_out", "module decoder.out (Dense.forward)")])
def test_nan_debugging_names_the_first_non_finite_output(where, named):
    """A NaN in the text LSTM's weights comes out of K4's autograd
    Function first; one in the vocabulary projection out of the decoder's
    ``out`` Dense. Anomaly mode is on inside and restored after."""
    from mmqg_tpu_torch.models import qg_model as TQ

    mc, model, batch = _nan_model()
    with torch.no_grad():
        if where == "text_enc":
            model.text_enc.lstm.layers[0].wx[0, 0] = float("nan")
        else:
            model.decoder.out.w[0, 0] = float("nan")
    TQ.loss_fn(model, mc, batch, train=True, dtype=torch.float32)  # no check
    assert not torch.is_anomaly_enabled()
    with pytest.raises(FloatingPointError, match=re.escape(named)):
        with profiling.nan_debugging(model=model):
            assert torch.is_anomaly_enabled()
            TQ.loss_fn(model, mc, batch, train=True, dtype=torch.float32)
    assert not torch.is_anomaly_enabled()
    with profiling.nan_debugging(False):       # disabled: no check
        TQ.loss_fn(model, mc, batch, train=True, dtype=torch.float32)


def test_nan_debugging_backward_and_clean_forward():
    """A finite forward passes the checks; a NaN made in the backward
    raises from anomaly mode."""
    from mmqg_tpu_torch.models import qg_model as TQ

    mc, model, batch = _nan_model()
    with profiling.nan_debugging(model=model):
        obj, _ = TQ.loss_fn(model, mc, batch, train=True,
                            dtype=torch.float32)
        obj.backward()
        x = torch.ones(3, requires_grad=True)
        y = x.sqrt() * 0.0
        with pytest.raises(RuntimeError, match="nan"):
            (y - x.detach().sqrt()).sum().backward(
                torch.tensor(float("inf")))


def test_nan_debug_cli_raises_naming_k4(tiny_config, tiny_corpus, tmp_path):
    """``train --nan-debug`` on a corpus whose embedding matrix holds a
    NaN: the first non-finite output is K4's, named; without the flag the
    epoch runs to its end."""
    from mmqg_tpu_torch.train import main

    cfg, *_ = _tiny_text(tiny_config, tmp_path)
    data = tmp_path / "data"
    shutil.copytree(cfg.data_path, data)
    cfg = cfg.replace(data_path=data)
    emb = np.load(cfg.weights_matrix_file)
    emb[:] = np.nan
    np.save(cfg.weights_matrix_file, emb)
    path = cfg.save(tmp_path / "nan.json")
    args = ["-c", str(path), "--mode", "text", "--epochs", "1", "--device",
            "cpu"]
    with pytest.raises(FloatingPointError, match="_LSTMLayerTrain"):
        main(args + ["--nan-debug"])
    main(args)
    assert not torch.is_anomaly_enabled()


def test_step_timer_samples_as_the_jax_one():
    """The same calls sample at the same steps, the samples per step."""
    from mmqg_tpu.utils import profiling as JP

    port, ref = profiling.StepTimer(sync_every=3), JP.StepTimer(sync_every=3)
    got, want = [], []
    for timer, out in ((port, got), (ref, want)):
        assert np.isnan(timer.median)
        timer.start()
        for i in range(7):
            res = timer.stop({"loss": np.float32(i)} if timer is ref
                             else {"loss": torch.tensor(float(i))})
            out.append(res is None)
    assert got == want == [True, True, False, True, True, False, True]
    assert len(port.samples) == len(ref.samples) == 2
    assert port.median > 0 and np.isfinite(port.median)
    port.stop(None)         # no result: synchronises the device, if any


def test_param_mem_mb_matches_jax(tiny_config):
    from mmqg_tpu.utils import profiling as JP
    from mmqg_tpu_torch.compat.from_jax import (params_from_numpy,
                                                train_state_to_numpy)
    from tests.torch_port_fixtures import tiny_model

    _, params, state = tiny_model(tiny_config, seed=2)
    model = params_from_numpy(params, state, "cpu")
    tree = train_state_to_numpy(model, {}, 0)
    want = JP.param_mem_mb({"params": tree["params"],
                            "model_state": tree["model_state"]})
    assert profiling.param_mem_mb(model) == want
    as_tensors = {k: [torch.from_numpy(np.array(v)) for v in
                      _leaves(tree[k])] for k in ("params", "model_state")}
    assert profiling.param_mem_mb(as_tensors) == want
    assert profiling.param_mem_mb({"params": tree["params"],
                                   "model_state": tree["model_state"]}
                                  ) == want


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_device_memory_report_on_the_cpu():
    """Without a card: one "cpu" entry under the JAX report's key, which
    counts the given tensors' storages, each once (a view adds nothing)."""
    from mmqg_tpu.utils import profiling as JP

    a = torch.zeros(1000)
    b = torch.zeros(250, dtype=torch.float64)
    report = profiling.device_memory_report({"a": a, "view": a[10:],
                                             "b": [b]})
    assert set(report) == {"cpu"}
    assert report["cpu"] == {"bytes_in_use_mb": (4000 + 2000) / 1e6}
    ref = JP.device_memory_report()
    assert all("bytes_in_use_mb" in v for v in ref.values())
    assert profiling.device_memory_report() == {"cpu":
                                                {"bytes_in_use_mb": 0.0}}


def test_audit_matches_jax(tiny_config, tiny_corpus):
    from mmqg_tpu.utils import audit as JA

    assert audit.audit_corpus(tiny_config) == JA.audit_corpus(tiny_config)
    corpus = [{"q": "a b c"}, {"q": "d"}, {"q": ""}]
    assert audit.get_maxlen_text(corpus, "q") == JA.get_maxlen_text(corpus,
                                                                    "q")
    assert audit.get_maxlen_text([], "q") == JA.get_maxlen_text([], "q")
    assert audit.get_maxlen_frames(tiny_config.salient_frames_path) == \
        JA.get_maxlen_frames(tiny_config.salient_frames_path)


def test_plotting_matches_jax(tmp_path):
    from mmqg_tpu.utils import plotting as JPL

    stats = {"train": {"loss": [3.0, 2.5, 2.7]},
             "val": {"loss": [3.1, 2.9, 3.0], "bleu": [0.1, 0.3, 0.2]}}
    path = tmp_path / "stats.json"
    path.write_text(json.dumps(stats))
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = plotting.plot_results(path, tmp_path / "port")
    assert got == JPL.plot_results(path, tmp_path / "jax")
    assert plotting.best_epoch_stats(stats) == JPL.best_epoch_stats(stats)
    for name in ("train_loss.png", "val_bleu.png"):
        assert (tmp_path / "port" / name).stat().st_size > 0
    rng = np.random.default_rng(0)
    grads = {"enc": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                     "b": rng.standard_normal(4).astype(np.float32)},
             "bns": [{"scale": rng.standard_normal(2).astype(np.float32)}]}
    tensors = {"enc": {k: torch.from_numpy(v) for k, v in
                       grads["enc"].items()},
               "bns": [{"scale": torch.from_numpy(grads["bns"][0]["scale"])
                        .to(torch.bfloat16)}]}
    want = JPL.grad_norms_by_layer(grads)
    got = plotting.grad_norms_by_layer(tensors)
    assert [n for n, _ in got] == [n for n, _ in want] == [
        "enc/w", "enc/b", "bns/0/scale"]
    np.testing.assert_array_equal([v for _, v in got[:2]],
                                  [v for _, v in want[:2]])
    np.testing.assert_allclose(got[2][1], want[2][1], rtol=1e-2)  # bf16
    out = plotting.plot_grad_flow(tensors, tmp_path / "flow.png")
    assert out.stat().st_size > 0
