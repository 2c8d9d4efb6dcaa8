"""chip_smoke.py, rehearsed on the CPU: it refuses to run without a CUDA
device (and alone, without the repo), and its request, pipeline and
training driving works end to end at a tiny size with the plain kernel
versions."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from mmqg_tpu_torch.compat.from_jax import params_from_numpy
from mmqg_tpu_torch.models import qg_model
from mmqg_tpu_torch.models.qg_model import ModelConfig, init_params
from mmqg_tpu_torch.ops.attention import trimodal_attention
from mmqg_tpu_torch.ops.lstm import lstm_seq
from mmqg_tpu_torch.optim import tree_leaves
from mmqg_tpu_torch.pipeline import QGPipeline
from mmqg_tpu_torch.train import Trainer, batch_arrays

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent


def _run(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def _printed_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if isinstance(obj, dict) and ("ok" in obj or "kernels" in obj):
            return True
    return False


def test_refuses_without_cuda_and_alone(tmp_path):
    proc = _run(REPO)
    assert proc.returncode != 0 and not _printed_result(proc.stdout)
    assert "no CUDA device" in proc.stderr
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    alone = _run(tmp_path)
    assert alone.returncode != 0 and not _printed_result(alone.stdout)


def test_main_path_rehearsal_on_cpu():
    """The phase-5/6 driving (requests, pipeline, encode + decode with
    logits) at tiny widths, where every kernel wrapper runs its plain
    version and so counts no launch."""
    mc = ModelConfig(n_vocab=50, word_emb_dim=8, hidden_dim=16, text_layers=2,
                     dec_layers=2, video_hidden_dim=16, audio_emb_dim=8,
                     flatten_dim=10, context_max_length=12, av_max_length=5,
                     target_steps=5, frame_size=32, mel_frames=16,
                     mel_bins=16, sample_rate=1600, stft_window=64,
                     stft_hop=32)
    params, state = init_params(mc, seed=0)
    words = ["<pad>", "<start>", "<end>"] + [f"w{i}" for i in range(3, 50)]
    vocab = {w: i for i, w in enumerate(words)}
    i2w = {str(i): w for i, w in enumerate(words)}
    pipe = QGPipeline(None, mc, params, state, vocab, i2w, device="cpu",
                      dtype=torch.float32)
    req = chip_smoke.requests(mc, 3, seed=1)
    assert all(1 <= len(f) <= mc.av_max_length for f in req[1])
    lstm_seq.launches = trimodal_attention.launches = 0
    questions = pipe.generate(*req)
    assert len(questions) == 3
    assert lstm_seq.launches == 0 and trimodal_attention.launches == 0
    mem, toks, logits = chip_smoke._encode_decode(pipe, req)
    assert tuple(logits.shape) == (4, mc.target_steps - 1, mc.n_vocab)
    assert bool(torch.isfinite(logits).all())
    assert questions == pipe._to_words(toks.numpy())[:3]
    np.testing.assert_array_equal(mem.text_len.numpy()[3:], 1)


def test_int8_card_vs_cpu_driving_rehearsal_on_cpu():
    """Phase 6's int8 comparison on the CPU at tiny widths: the audio
    memory comes from AudioEncoder.forward(int8=True) (the plain int8 conv
    here), replaces the float tower's, and the decode runs on it."""
    mc, params, state, i2w = _tiny_train_model()
    mc = mc._replace(audio_int8_serving=False)
    vocab = {w: int(i) for i, w in i2w.items()}
    params = chip_smoke.he_vggish(params)
    pipe = QGPipeline(None, mc, params, state, vocab, i2w, device="cpu",
                      dtype=torch.float32)
    req = chip_smoke.requests(mc, 3, seed=5)
    mem_f, _, _ = chip_smoke._encode_decode(pipe, req)
    chip_smoke._reset_launches()
    mem_q, toks, logits = chip_smoke._encode_decode(pipe, req,
                                                    int8_audio=True)
    assert set(chip_smoke._launches().values()) == {0}
    again = chip_smoke._encode_decode(pipe, req, int8_audio=True)
    assert torch.equal(again[1], toks) and torch.equal(again[2], logits)
    assert bool(torch.isfinite(logits).all())
    assert mem_q.enc_audio.shape == mem_f.enc_audio.shape
    assert not torch.equal(mem_q.enc_audio, mem_f.enc_audio)
    torch.testing.assert_close(mem_q.enc_text, mem_f.enc_text)
    # zero past each row's example count
    past = (torch.arange(mc.av_max_length)[None, :]
            >= mem_q.audio_len[:, None])
    assert bool(past.any()) and not bool(mem_q.enc_audio[past].any())


def test_strategies_phase_rehearsal_on_cpu():
    """The strategies phase's driving at tiny widths on the CPU: beam and
    the sampled strategies through generate(), the per-row check (every
    row served alone equals its row in the batch), every strategy's tokens
    from two pipelines, evaluate() over the synthetic corpus, and the media
    probe; the kernel wrappers run their plain versions and count nothing."""
    mc, params, state, i2w = _tiny_train_model()
    vocab = {w: int(i) for i, w in i2w.items()}
    pipe = QGPipeline(None, mc, params, state, vocab, i2w, device="cpu",
                      dtype=torch.float32)
    req = chip_smoke.requests(mc, 5, seed=3)
    chip_smoke._reset_launches()
    beam = pipe.generate(*req, strategy="beam",
                         beam_size=chip_smoke.BEAM_SIZE)
    assert len(beam) == 5 and all(isinstance(q, str) for q in beam)
    for strategy, k, p in chip_smoke.DRAWS:
        together, differ = chip_smoke.per_row_check(pipe, req, strategy, k, p,
                                                    range(5))
        assert len(together) == 5 and differ == []
    ids = chip_smoke.row_ids(6)
    assert max(ids) >= 2**31 and min(ids) < 0
    small = tuple(r[:4] for r in req)
    a = chip_smoke.strategy_tokens(pipe, small)
    other = QGPipeline(None, mc, params, state, vocab, i2w, device="cpu",
                       dtype=torch.float32)
    b = chip_smoke.strategy_tokens(other, small)
    assert set(a) == {"beam", "sampling", "topk", "topp", "logprob"}
    for key in a:
        assert torch.equal(a[key], b[key]), key
    assert a["beam"].shape == (4, mc.target_steps - 1)
    assert bool(torch.isfinite(a["logprob"]).all())
    corpus = chip_smoke.SyntheticCorpus(mc, i2w, 2, 4, seed=4)
    for strategy in ("beam", "sampling"):
        preds, bleu = chip_smoke.evaluate_corpus(pipe.model, mc, corpus,
                                                 strategy)
        assert [p["question_id"] for p in preds] == list(range(8))
    assert set(chip_smoke._launches().values()) == {0}
    assert chip_smoke.media_probe().startswith("host media: cv2 ")


def test_bound_is_the_larger_of_operations_and_bytes():
    b = chip_smoke.bound(989e12, 0, torch.bfloat16)
    assert b == {"bound_ms": 1000.0, "bound_by": "operations"}
    b = chip_smoke.bound(1979e9, 3.35e12, torch.int8)
    assert b == {"bound_ms": 1000.0, "bound_by": "bytes"}
    assert chip_smoke.nbytes(torch.zeros(3, 4), torch.zeros(
        5, dtype=torch.int8)) == 53


def test_swin_trunk_check_wants_one_trunk_of_24_attentions():
    """The configs phase's Swin check: one trunk of 24 window attentions
    over some live windows a generate() of the swin3d configuration, and
    no trunk in any other."""
    from unittest import mock

    from mmqg_tpu_torch.models import video_swin as VS

    swin = ModelConfig(n_vocab=50, video_encoder="swin3d",
                       video_hidden_dim=1024, frame_size=224)
    with mock.patch.dict(VS.windows):
        before = dict(VS.windows)
        chip_smoke.check_swin_trunks("rehearsal", ModelConfig(n_vocab=50),
                                     before)
        with pytest.raises(AssertionError, match="video_swin.windows"):
            chip_smoke.check_swin_trunks("rehearsal", swin, before)
        for key, n in (("trunks", 1), ("attn_calls", 24), ("windows", 9),
                       ("live_windows", 4)):
            VS.windows[key] += n
        chip_smoke.check_swin_trunks("rehearsal", swin, before)
        for mc in (ModelConfig(n_vocab=50), swin._replace(mode="text")):
            with pytest.raises(AssertionError, match="video_swin.windows"):
                chip_smoke.check_swin_trunks("rehearsal", mc, before)
        VS.windows["live_windows"] -= 4
        with pytest.raises(AssertionError, match="video_swin.windows"):
            chip_smoke.check_swin_trunks("rehearsal", swin, before)


def test_window_attention_check_wants_24_launches_a_swin_generate():
    """The configs phase's kernel check: 24 window attention launches a
    generate() of the swin3d configuration (one a block), none in any
    other."""
    from unittest import mock

    from mmqg_tpu_torch.ops import window_attention as WA

    swin = ModelConfig(n_vocab=50, video_encoder="swin3d",
                       video_hidden_dim=1024, frame_size=224)
    with mock.patch.object(WA.window_attention, "launches", 7):
        chip_smoke.check_window_attention_launches(
            "rehearsal", ModelConfig(n_vocab=50), 7)
        with pytest.raises(AssertionError, match="window_attention"):
            chip_smoke.check_window_attention_launches("rehearsal", swin, 7)
        WA.window_attention.launches += 24
        chip_smoke.check_window_attention_launches("rehearsal", swin, 7)
        for mc in (ModelConfig(n_vocab=50), swin._replace(mode="text")):
            with pytest.raises(AssertionError, match="window_attention"):
                chip_smoke.check_window_attention_launches("rehearsal", mc,
                                                           7)


def _tiny_train_model():
    mc = ModelConfig(n_vocab=50, word_emb_dim=8, hidden_dim=16, text_layers=2,
                     dec_layers=2, video_hidden_dim=16, audio_emb_dim=8,
                     flatten_dim=10, context_max_length=12, av_max_length=5,
                     target_steps=5, frame_size=32, mel_frames=16,
                     mel_bins=16, sample_rate=1600, stft_window=64,
                     stft_hop=32)
    params, state = init_params(mc, seed=0)
    i2w = {str(i): w for i, w in enumerate(
        ["<pad>", "<start>", "<end>"] + [f"w{i}" for i in range(3, 50)])}
    return mc, params, state, i2w


def test_train_phase_rehearsal_on_cpu():
    """Phase 8's driving (synthetic corpus, Trainer.run_epoch, the AV caps
    Trainer picks, validate) at tiny widths on the CPU, where K4, K1 and
    K2 run their plain versions and count no launch."""
    mc, params, state, i2w = _tiny_train_model()
    train_ds = chip_smoke.SyntheticCorpus(mc, i2w, 2, 4, seed=1)
    val_ds = chip_smoke.SyntheticCorpus(mc, i2w, 1, 4, seed=2)
    b = train_ds.batch(0)
    assert b.frames.shape[2:] == (32, 32, 3) and b.size == 4
    assert (b.target_ids[np.arange(4), b.target_len - 1] == 2).all()
    np.testing.assert_array_equal(  # made from its seed alone
        train_ds.batch(1).frames,
        chip_smoke.SyntheticCorpus(mc, i2w, 2, 4, seed=1).batch(1).frames)
    trainer = Trainer(chip_smoke.train_config(4), mc,
                      params["embedding"]["table"], train_ds, val_ds,
                      device="cpu",
                      log_fn=lambda *a: None)
    chip_smoke._reset_launches()
    loss = trainer.run_epoch(0)
    val = trainer.validate()
    assert np.isfinite(loss) and np.isfinite(val["loss"])
    assert trainer.train_state.step == 2
    assert set(chip_smoke._launches().values()) == {0}


def test_train_card_vs_cpu_step_rehearsal_on_cpu():
    """Phase 9's one step, twice on the CPU: the same loss, gradients and
    updated parameters (the phase compares the card with this)."""
    mc, params, state, i2w = _tiny_train_model()
    host = batch_arrays(chip_smoke.SyntheticCorpus(mc, i2w, 1, 4, 3).batch(0))
    caps = {"audio_cap": 5, "frames_cap": 5}
    params = chip_smoke.he_vggish(params)
    a = chip_smoke._train_step_on("cpu", (params, state), mc, host, caps)
    b = chip_smoke._train_step_on("cpu", (params, state), mc, host, caps)
    assert a[0] == b[0] and np.isfinite(a[0])
    for x, y in zip(tree_leaves(a[1]) + tree_leaves(a[2]),
                    tree_leaves(b[1]) + tree_leaves(b[2])):
        assert torch.equal(x, y)
    assert set(a[3]) == {"fc1", "fc2", "fc3"}
    names = list(chip_smoke._leaf_names(qg_model.param_tree(
        params_from_numpy(params, state))))
    assert len(names) == len(tree_leaves(a[1])) and names[0].startswith("/")
    lines, failed = chip_smoke.compare_train_steps(a, b, names)
    assert not failed and "/decoder/attn/b_audio 0.00e+00" in lines[1]
    # He-scaled VGGish convs and tones give the audio attention's scores a
    # gradient far above f32 noise (3e-7 here, and ~1e-8 at full width, with
    # the default init)
    grads = dict(zip(names, tree_leaves(a[1])))
    assert float(grads["/decoder/attn/b_audio"].abs().max()) > 2e-5
    # one leaf off by 1e-3 of its max fails, and is named
    off = [g.clone() for g in tree_leaves(a[1])]
    i = names.index("/decoder/attn/b_audio")
    off[i] = off[i] + 1e-3 * float(off[i].abs().max())
    g_off = chip_smoke.tree_map(lambda g: g, a[1])
    _assign_leaves(g_off, iter(off))
    lines, failed = chip_smoke.compare_train_steps(
        (a[0], g_off, a[2], a[3]), b, names)
    assert failed and lines[-1].endswith("/decoder/attn/b_audio")
    # the conv towers' leaves have their own band: 1e-3 off passes there
    off[i] = tree_leaves(a[1])[i]
    j = names.index("/audio_enc/fc1/w")
    off[j] = off[j] + 1e-3 * float(off[j].abs().max())
    _assign_leaves(g_off, iter(off))
    lines, failed = chip_smoke.compare_train_steps(
        (a[0], g_off, a[2], a[3]), b, names)
    assert not failed and "/audio_enc/fc1/w 1.00e-03" in lines[0]
    assert "fc1 0 of" in lines[2]


def _assign_leaves(tree, it):
    """Replace ``tree``'s leaves in place, in ``tree_leaves`` order."""
    keys = sorted(tree) if isinstance(tree, dict) else range(len(tree))
    for k in keys:
        if isinstance(tree[k], (dict, list)):
            _assign_leaves(tree[k], it)
        else:
            tree[k] = next(it)


def test_video_and_serve_phases_rehearsal_on_cpu(tmp_path):
    """The video and serve phases' building and checking at a tiny size on
    the CPU: lecture fixtures and their span layout, the dispatch counter,
    the media route check, the daemon's request lines answered by serve()
    (every id once, the malformed line an error), and a checkpoint the
    port loads."""
    import io
    import json

    from mmqg_tpu_torch.config import Config
    from mmqg_tpu_torch.serve import serve

    tiny = dict(glove_emb_dim=8, text_lstm_hidden_dim=16, text_lstm_layers=2,
                dec_lstm_hidden_dim=16, dec_lstm_layers=2,
                video_hidden_dim=16, audio_emb=8, flatten_dim=10,
                context_max_length=12, av_max_length=5, question_max_length=4,
                frame_size=32, mel_frames_per_example=16, mel_bins=16,
                audio_sample_rate=1600, stft_window=64, stft_hop=32)
    mc = ModelConfig.from_config(Config(**tiny), n_vocab=50)
    params, state = init_params(mc, seed=0)
    vocab, i2w = chip_smoke.alpha_vocab(mc.n_vocab)
    assert len(vocab) == 50 and all(w.isalpha() for w in list(vocab)[3:])
    jobs, durations = chip_smoke.make_lectures(
        tmp_path, i2w, n_videos=3, n_questions=4, seconds=(6, 9),
        size=(64, 48), fps=10, wav_rate=8000, seed=1)
    assert sum(len(j["spans"]) for j in jobs) == 4 and len(durations) == 3
    for job, d in zip(jobs, durations):
        assert job["video_path"].exists() and job["audio_path"].exists()
        assert "-->" in job["subtitles"].read_text()
    # the flagship's layout: 20 spans of 4-30 s, some as "M:SS"
    rng = np.random.default_rng(0)
    layout = chip_smoke.span_layout(rng, list(rng.integers(30, 121, 16)),
                                    20)
    spans = [s for v in layout for s in v]
    assert len(spans) == 20 and {len(v) for v in layout} == {1, 2}
    secs = [(int(a.split(":")[0]) * 60 + int(a.split(":")[1]),
             int(b.split(":")[0]) * 60 + int(b.split(":")[1]))
            if isinstance(a, str) else (a, b) for a, b in spans]
    assert all(4 <= b - a <= 30 for a, b in secs)
    assert any(isinstance(s[0], str) for s in spans)

    pipe = QGPipeline(None, mc, params, state, vocab, i2w, device="cpu",
                      dtype=torch.float32)
    sizes, starts = chip_smoke.counting_dispatches(pipe)
    chip_smoke._reset_media_routes()
    per_video = pipe.generate_from_videos(jobs, workers=2)
    assert len(sizes) == len(starts) == 3 and sum(sizes) == 4
    assert starts == sorted(starts)
    chip_smoke.check_media_routes("rehearsal", 3, "wav")
    coalesced = pipe.generate_from_videos(jobs, workers=2, coalesce=True)
    assert coalesced == per_video and chip_smoke.n_equal(
        coalesced, per_video) == 4

    preps = [pipe._prep_video(j["video_path"], j["spans"],
                              subtitles=j["subtitles"],
                              audio_path=j["audio_path"]) for j in jobs]
    assert all(c for p in preps for c in p[0])  # contexts kept their words
    text, ids = chip_smoke.serve_requests(jobs, preps, tmp_path, 9,
                                          mc.sample_rate)
    reqs = [json.loads(line) for line in text.splitlines()
            if "malformed" not in line]
    assert len(reqs) == 8 and {"video" in r for r in reqs} == {True, False}
    out = io.StringIO()
    assert serve(pipe, strategy="greedy", max_batch=32, linger_ms=25.0,
                 inp=io.StringIO(text), out=out) == 9
    chip_smoke.check_answers("rehearsal", [
        json.loads(line) for line in out.getvalue().splitlines()], ids, 1)

    path = chip_smoke.write_checkpoint(tmp_path, (mc, params, state, None,
                                                  None), **tiny)
    loaded = QGPipeline.from_checkpoint(Config.load(path), device="cpu",
                                        dtype=torch.float32)
    assert loaded.vocab == vocab and loaded.mc == mc
    assert loaded.generate(["wabc"]) == pipe.generate(["wabc"])


def test_dp_phase_rehearsal_on_cpu(monkeypatch):
    """Phase 17's driving at tiny widths on the CPU: the sharded pipeline
    over two replicas gives the unsharded tokens for every strategy and
    the per-batch stream (the launch checks need the card: no launch is
    counted here), and one process's train step reports what the ranks
    are compared by."""
    mc, params, state, i2w = _tiny_train_model()
    vocab = {w: int(i) for i, w in i2w.items()}
    model = (mc, params, state, vocab, i2w)
    monkeypatch.setattr(chip_smoke, "check_dp_launches", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "DP_REQUESTS", 5)   # 8 rows
    monkeypatch.setattr(chip_smoke, "DP_LARGE", 9)
    monkeypatch.setattr(chip_smoke, "DP_TRAIN_B", 4)
    out = chip_smoke._dp_serving("cpu", model, "cpu")
    assert out["replicas"] == 2 and set(out["launches"].values()) == {0}
    assert out["generate_ms"][9].keys() == {"unsharded", "sharded"}
    host, caps = chip_smoke._dp_batch(mc, i2w)
    half = chip_smoke.DP_TRAIN_B // 2
    assert host["frames_len"][half:].max() <= chip_smoke.DP_SHORT_FRAMES
    step = chip_smoke._dp_step((params, state), mc, host, caps, None, "cpu")
    assert np.isfinite(step["loss"]) and step["differ"] == 0.0
    assert set(step) >= {"grads", "params", "launches", "fwd_routes",
                         "bwd_routes", "step_ms", "allreduce_ms", "grad_mb"}
    assert step["launches"]["lstm_train_fwd"] == 0


def test_offline_phase_rehearsal_on_cpu(tmp_path):
    """Phase 18 is run by main(), and its host half works at a tiny size
    on the CPU: the raw corpus, the prepare CLI in a child process (its
    lines, stage times, routes and artifacts), extract_audio's route, and
    the reference artifacts' round trip with the f32 serving check (the
    launch checks need the card)."""
    import inspect

    from mmqg_tpu_torch.config import Config

    assert "phase_offline(dev[\"card\"], model)" in inspect.getsource(
        chip_smoke.main)
    config = Config(output_path=tmp_path / "results",
                    dataset_path=tmp_path / "dataset",
                    data_path=tmp_path / "data",
                    glove_path=tmp_path / "glove.6B", glove_emb_dim=8,
                    frame_size=32)
    corpus = chip_smoke.write_raw_corpus(config, n_videos=2, per_video=6,
                                         seconds=(8, 10), size=(64, 48),
                                         fps=10)
    assert corpus["questions"] == 12
    prep = chip_smoke.run_prepare(config.save(), workers=2)
    assert prep["lines"][0] == ("saliency: {'audio': 0, 'frames': 12, "
                                "'clips': 12, 'texts': 12}")
    assert prep["lines"][-1] == "Done !"
    assert set(prep["stage_ms"]) == {"saliency", "glove", "text", "data"}
    route = chip_smoke.expected_frame_route()
    assert prep["frame_routes"] == {r: 2 * (r == route)
                                    for r in prep["frame_routes"]}
    assert not any(prep["audio_routes"].values())
    assert chip_smoke.check_prepared(config, 12, 32) == (9, 1, 2)
    probe = chip_smoke.probe_extract_audio(config, "lec00")
    assert probe["routes"][chip_smoke.expected_audio_route()] == 1

    mc, params, state, i2w = _tiny_train_model()
    vocab = {w: int(i) for i, w in i2w.items()}
    out = chip_smoke.reference_round_trip(
        "cpu", (mc, params, state, vocab, i2w), tmp_path, device="cpu",
        n_requests=3)
    assert out["leaves"] > 40 and set(out["launches"].values()) == {0}


def test_train_features_phase_rehearsal_on_cpu(tmp_path):
    """Phase 19 is run by main(), and its driving works at tiny widths on
    the CPU (mode text): two spawned gloo ranks take the f32 steps of the
    three modes (the sharded states equal the plain one's) and the bf16
    steps in turns, holding the rule's bytes; the Trainer epoch traces a
    warm step; the checkpoints round-trip by both backends."""
    import inspect

    assert "phase_train_features(dev[\"card\"], model)" in \
        inspect.getsource(chip_smoke.main)
    mc, params, state, i2w = _tiny_train_model()
    mc = mc._replace(mode="text")
    params = {k: v for k, v in params.items()
              if k not in ("video_enc", "audio_enc")}
    vocab = {w: int(i) for i, w in i2w.items()}
    model = (mc, params, {}, vocab, i2w)
    ranks = chip_smoke._features_ranks("cpu", model, "cpu")
    assert ranks["backend"] == "gloo"
    assert ranks["worst_share"] <= chip_smoke.FEATURES_RTOL
    held = ranks["held_mib"]
    assert held["zero1"]["params"] == held["plain"]["params"]
    assert held["zero1"]["opt_state"] < 0.6 * held["plain"]["opt_state"]
    assert held["fsdp"]["params"] < 0.6 * held["plain"]["params"]
    assert set(ranks["collective_ms"]) == {"all_reduce", "reduce_scatter",
                                           "all_gather"}
    trained = chip_smoke._features_trainer("cpu", model, tmp_path,
                                           device="cpu", n_batches=2)
    assert trained["trainer"]._profiled
    assert trained["traced"]["events"] > 0
    assert not (tmp_path / "trace").exists()
    assert set(trained["launches"].values()) == {0}
    out = chip_smoke._features_checkpoints("cpu", trained["trainer"],
                                           tmp_path)
    assert out["tensorstore"] and out["msgpack_mib"] > 0
    assert set(out["blocked_ms"]) == {"sync", "async"}
    assert not (tmp_path / "ckpt").exists()
