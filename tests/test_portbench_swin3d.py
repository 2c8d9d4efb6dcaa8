"""The benchmark's Video Swin-B cell on the CPU: the harness finds its
files by name, ``arith_swin3d`` counts the trunk and its attention as a
hand count does, the program's window counter agrees with both, the
``swin.*`` spans open only on the ``swin3d`` branch, the readers read
nothing without their sources, and a whole run at a tiny size (the trunk
at its published widths) is correct and reads the cell's program
metrics."""

import json
import shutil

import numpy as np
import pytest
import torch

from mmqg_tpu_torch.models import video_swin as S
from mmqg_tpu_torch.utils import profiling
from portbench import arith_swin3d as A
from portbench import run as R
from portbench.tests.conftest import TINY, TINY_MIX, tiny_copy

torch.set_num_threads(1)
CELL = "trimodal_attn_swin3d_b.serve_bulk"
READERS = ("swin3d_mfu.serve", "swin3d_attn_roofline.serve",
           "swin3d_padded_tokens.serve")
COUNTER = ("trunks", "attn_calls", "windows", "live_windows", "tokens",
           "live_tokens", "skipped")


def _zeroed(monkeypatch):
    """The counter is the process's; start it at zero, as a benchmark
    run's process does, whatever trunks ran before on this worker."""
    counter = dict.fromkeys(COUNTER, 0)
    monkeypatch.setattr(S, "windows", counter)
    return counter


def test_the_catalog_finds_the_cell_and_its_files():
    cat = R.catalog()
    assert CELL in cat["workloads"]
    assert "trimodal_attn_swin3d_b" in cat["configs"]
    assert "bulk_b32_swin3d" in cat["mixes"]
    assert "serve_bulk_swin3d" in cat["traffic"]
    assert set(READERS) <= set(cat["metrics"])
    bench = json.loads((R.HERE.parent / "BENCHMARK.json").read_text())
    want = {m["name"] for m in R.metric_names(
        bench, CELL, "per_layer", {"questions_per_s"})}
    assert want == set(READERS)
    mix = json.loads((R.HERE / "mixes" / "bulk_b32_swin3d.json").read_text())
    base = json.loads((R.HERE / "mixes" / "bulk_b32.json").read_text())
    assert {k: v for k, v in mix.items() if k not in ("kind", "about")} == \
        {k: v for k, v in base.items() if k not in ("kind", "about")}
    cfg = json.loads((R.HERE / "configs" / "trimodal_attn_swin3d_b.json")
                     .read_text())
    r2 = json.loads((R.HERE / "configs" / "trimodal_attn_r2plus1d.json")
                    .read_text())
    changed = {k for k in cfg if k in r2 and cfg[k] != r2[k]}
    # swin3d_b's released weights expect ImageNet's frame statistics
    assert changed == {"source", "about", "assumed", "video_encoder",
                       "frame_size", "video_hidden_dim", "vid_mean",
                       "vid_std"}


# 8 frames of 64 x 64, by hand: (stage width C, tokens N, window volume V)
HAND = [(128, 4 * 16 * 16, 4 * 7 * 7), (256, 4 * 8 * 8, 4 * 7 * 7),
        (512, 4 * 4 * 4, 4 * 4 * 4), (1024, 4 * 2 * 2, 4 * 2 * 2)]


def test_arith_counts_the_trunk_as_a_hand_count():
    macs = A.trunk_macs(8, 64)
    n0 = HAND[0][1]
    assert macs["patch"] == n0 * 96 * 128
    assert macs["linear"] == sum(d * 12 * n * c * c for d, (c, n, _) in
                                 zip(A.DEPTHS, HAND))
    assert macs["attention"] == sum(d * 2 * n * v * c for d, (c, n, v) in
                                    zip(A.DEPTHS, HAND))
    assert macs["merge"] == sum(n * 4 * (c // 2) * c for c, n, _ in HAND[1:])
    assert A.trunk_flops(8, 64) == 2.0 * sum(macs.values())
    # one 101-frame clip at 224: ~755 G multiply-adds in the linears and
    # ~124 G in the window attention
    big = A.trunk_macs(101)
    assert big["linear"] == 754672730112
    assert big["attention"] == 124386705408


def test_request_flops_attends_over_the_memory_steps():
    """23 and 24 frames make 12 memory steps each: beyond the trunk, a
    request costs the same."""
    cfg = json.loads((R.HERE / "configs" / "trimodal_attn_swin3d_b.json")
                     .read_text())
    f = {n: A.request_flops(cfg, 100, n, 5, 21) - A.trunk_flops(n)
         for n in (23, 24, 25)}
    assert f[23] == f[24] < f[25]


# two clips of 20 and 9 frames at 64 x 64 (10 and 5 temporal tokens, the
# bucket's 10 padded to 16), by hand over swin3d_b's 24 blocks: per stage
# (spatial windows a temporal window, window volume, padded H x W, and the
# live temporal windows of the two clips in an unshifted and a shifted
# block: the 9-frame clip's second window holds only padding unshifted,
# and the wrapped-in tokens 0-3 shifted)
WINDOWS = [(9, 392, 21 * 21, 2 + 1, 2 + 2), (4, 392, 14 * 14, 2 + 1, 2 + 2),
           (1, 128, 4 * 4, 2 + 1, 2 + 2), (1, 32, 2 * 2, 2 + 1, 2 + 2)]


def _hand_counts():
    out = dict.fromkeys(COUNTER, 0)
    out["trunks"] = 1
    for depth, (sp, vol, hw, live_u, live_s) in zip(A.DEPTHS, WINDOWS):
        out["attn_calls"] += depth
        out["windows"] += depth * 2 * 2 * sp
        out["tokens"] += depth * 2 * 2 * sp * vol
        out["live_windows"] += depth // 2 * (live_u + live_s) * sp
        out["live_tokens"] += depth * (10 + 5) * hw
    out["skipped"] = out["windows"] - out["live_windows"]
    return out


def test_one_trunk_counts_its_windows_as_a_hand_count(monkeypatch):
    """A narrow tree at swin3d_b's depths: 24 attention calls, and the
    windows and tokens computed and live as the hand count and
    ``arith_swin3d.attention_windows`` give them."""
    counter = _zeroed(monkeypatch)
    params, _ = S.init_numpy(np.random.RandomState(0), embed_dim=8,
                             heads=(1, 1, 2, 4))
    model = S.build(params, torch.tensor)
    with torch.no_grad():
        model.temporal(torch.zeros((2, 20, 64, 64, 3)),
                       torch.tensor([10, 5]), dtype=torch.float32)
    got = {k: int(v) for k, v in counter.items()}
    hand = _hand_counts()
    assert got == hand
    blocks = list(A.attention_windows([20, 9], 20, 64))
    assert len(blocks) == 24
    assert sum(b["windows"] for b in blocks) == hand["windows"]
    assert sum(b["live"] for b in blocks) == hand["live_windows"]
    assert sum(b["windows"] * b["tokens"] for b in blocks) == hand["tokens"]


def _tiny_pipeline(video_encoder):
    """A tiny f32 QGPipeline on the CPU (a narrow Video Swin tree for
    ``swin3d``: ``init_params`` draws swin3d_b alone) and a request of
    three examples with frames and audio."""
    from mmqg_tpu_torch.models.qg_model import ModelConfig, init_params
    from mmqg_tpu_torch.pipeline import QGPipeline

    mc = ModelConfig(n_vocab=30, word_emb_dim=8, hidden_dim=16, text_layers=2,
                     dec_layers=2, video_hidden_dim=64, audio_emb_dim=8,
                     flatten_dim=10, context_max_length=12, av_max_length=4,
                     target_steps=5, frame_size=32, mel_frames=16,
                     mel_bins=16, sample_rate=1600, stft_window=64,
                     stft_hop=32, video_encoder="conv_lstm")
    params, state = init_params(mc, seed=0)
    if video_encoder == "swin3d":
        params["video_enc"], state["video_enc"] = S.init_numpy(
            np.random.RandomState(1), embed_dim=8, depths=(2, 2, 2, 2),
            heads=(1, 1, 2, 4))
    elif video_encoder == "resnet":
        mc = mc._replace(video_hidden_dim=512)
        params, state = init_params(mc._replace(video_encoder="resnet"), 0)
    mc = mc._replace(video_encoder=video_encoder)
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


SWIN_SPANS = ("video.prepare", "video.trunk", "swin.attention", "swin.mlp",
              "swin.merge")


@pytest.mark.parametrize("video_encoder", ["conv_lstm", "resnet", "swin3d"])
def test_swin_spans_open_only_on_the_swin3d_branch(video_encoder, tmp_path):
    """On the ``swin3d`` branch one generate() opens ``video.prepare``,
    then ``video.trunk`` holding 8 ``swin.attention`` and ``swin.mlp``
    (a block each) and 3 ``swin.merge``; on the other branches no
    ``swin.*`` span."""
    pipe, req = _tiny_pipeline(video_encoder)
    pipe.generate(*req)
    with profiling.trace(tmp_path) as prof:
        pipe.generate(*req)
    got = sorted(((e.name, e.time_range.start, e.time_range.end)
                  for e in prof.events() if e.name in SWIN_SPANS),
                 key=lambda x: x[1])
    names = [n for n, _, _ in got]
    if video_encoder != "swin3d":
        assert not any(n.startswith("swin.") for n in names)
        return
    assert {n: names.count(n) for n in SWIN_SPANS} == {
        "video.prepare": 1, "video.trunk": 1, "swin.attention": 8,
        "swin.mlp": 8, "swin.merge": 3}
    (_, p0, p1), (_, t0, t1) = got[0], got[1]
    assert names[:2] == ["video.prepare", "video.trunk"]
    assert p1 <= t0 and all(t0 <= s <= e <= t1 for _, s, e in got[2:])


@pytest.mark.parametrize("metric", READERS)
def test_swin3d_readers_read_nothing_without_their_sources(metric,
                                                           monkeypatch):
    """The cell's readers return None on a trace with no spans, kernels or
    calls, for a program without the counter (the parent commit's) and
    for one whose trunk never ran, and do not raise."""
    from portbench import trace

    reader = R.load_module(R.HERE / "metrics" / f"{metric}.py")
    ctx = {"trace": trace.Trace(1.0), "cfg": {}, "calls": []}
    _zeroed(monkeypatch)
    assert reader.read(ctx) is None
    monkeypatch.delattr(S, "windows")
    assert reader.read(ctx) is None


def test_a_tiny_run_is_correct_and_reads_the_program(tmp_path, monkeypatch):
    """In float32: at this size a bf16 run's ``logit_gap_vs_fp8`` rests on
    a handful of near ties (0 to 0.41 over seeds), where f32 reads 0."""
    _zeroed(monkeypatch)
    root = tiny_copy(tmp_path / "portbench")
    cfg_path = root / "configs" / "trimodal_attn_swin3d_b.json"
    cfg = json.loads(cfg_path.read_text())
    assert all(cfg[k] == v for k, v in TINY.items())
    cfg["video_hidden_dim"] = 1024        # the trunk's width, no head
    cfg["compute_dtype"] = "float32"
    cfg_path.write_text(json.dumps(cfg))
    mix_path = root / "mixes" / "bulk_b32_swin3d.json"
    mix_path.write_text(json.dumps(dict(json.loads(mix_path.read_text()),
                                        **TINY_MIX["bulk_b32"])))
    out = R.run_cell(CELL, 2**33 + 17, 0.3, True, device="cpu", root=root,
                     bench_path=R.HERE.parent / "BENCHMARK.json")
    assert out["correct"] is True, out["checks"]
    assert set(out["checks"]) == {"logit_gap_vs_fp8", "unservable",
                                  "memory_gap_f32"}
    assert out["checks"]["memory_gap_f32"]["value"] < 1e-5
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert 0 < got["swin3d_mfu.serve"]
    assert 0 < got["swin3d_padded_tokens.serve"] < 1
    assert "swin3d_attn_roofline.serve" not in got    # no device kernels
    shutil.rmtree(root)


def _planted(monkeypatch, fault):
    """A fault confined to the port's trunk: the shifted blocks' region
    mask, every relative-position bias, or the padded keys' mask
    dropped."""
    if fault == "region":
        region = S._region_mask
        monkeypatch.setattr(S, "_region_mask",
                            lambda *a: torch.zeros_like(region(*a)))
    elif fault == "bias":
        init = S.Block.__init__

        def zeroed(self, norm1, qkv, rel_bias, *a, **kw):
            init(self, norm1, qkv, torch.zeros_like(rel_bias), *a, **kw)
        monkeypatch.setattr(S.Block, "__init__", zeroed)
    elif fault == "padding":
        key_neg = S.Rows.key_neg
        monkeypatch.setattr(S.Rows, "key_neg", lambda self, *a: (
            torch.zeros_like(key_neg(self, *a))))


@pytest.fixture(scope="module")
def judged_requests(tmp_path_factory):
    """A run of the cell at a narrow tree (embed 32, depth 2 a stage) over
    64 x 64 frames, where stages 1-3 shift in H and W, and the first
    requests a seed's judge samples."""
    from portbench import gen, judge
    from portbench.reference import swin3d

    root = tiny_copy(tmp_path_factory.mktemp("memory") / "portbench")
    cfg_path = root / "configs" / "trimodal_attn_swin3d_b.json"
    cfg_path.write_text(json.dumps(dict(
        json.loads(cfg_path.read_text()), video_hidden_dim=256,
        frame_size=64)))
    mix_path = root / "mixes" / "bulk_b32_swin3d.json"
    mix_path.write_text(json.dumps(dict(json.loads(mix_path.read_text()),
                                        **TINY_MIX["bulk_b32"])))
    seed = 2**33 + 17
    run = R.Run(CELL, seed, 0.1, False, "cpu", root)
    run.params, run.state = swin3d.make(run.cfg, seed, "cpu", embed_dim=32,
                                        depths=(2, 2, 2, 2),
                                        heads=(1, 2, 4, 8))
    run.vocab, run.index_to_word = gen.vocab(run.cfg["n_vocab"])
    answers = [judge.Answer(lambda c=c, f=f, a=a: (c, f, a), "w3")
               for b in gen.bulk_pool(run.cfg, run.mix, seed, "cpu")
               for c, f, a in zip(*b)]
    chosen = [answers[k] for k in judge.sample(answers, 4, seed)]
    return run, chosen


@pytest.mark.parametrize("fault", [None, "region", "bias", "padding"])
def test_the_f32_memory_check_fails_a_fault_in_the_trunk(
        judged_requests, monkeypatch, fault):
    """``memory_gap_f32`` reads f32 rounding for the program and fails
    each trunk fault, which moves the memory by more than a tenth of its
    max here (the served tokens hide a dropped region mask or bias at
    the cell's size: 0.0126 and 0.0251 of 0.25 on the card); the fp8
    control is far over the limit."""
    from portbench.traffic import serve_bulk_swin3d as D

    limit = json.loads((R.HERE / "workloads" / f"{CELL}.json").read_text())[
        "limits"]["memory_gap_f32"]
    run, chosen = judged_requests
    _planted(monkeypatch, fault)
    got = D.memory_gaps(run, chosen)
    assert got["control_memory_gap_f32"] > 10 * limit
    if fault is None:
        assert got["memory_gap_f32"] < 1e-5
    else:
        assert got["memory_gap_f32"] > 10 * limit
