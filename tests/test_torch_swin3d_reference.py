"""The port's Video Swin Transformer against the benchmark's plain
reference (``portbench/reference/swin3d.py``: float32 ``F.linear``,
``F.layer_norm`` and an explicit softmax, nothing of the port), the
published layout and the converter, on the CPU.

Seeded random weights (``swin3d.make``), f32:

* the trunk's memory (``VideoSwin.temporal``) within TRUNK_TOL of the
  memory's max: the same sums in other orders (the attention through
  ``F.scaled_dot_product_attention`` against an explicit softmax), 5.6e-7
  measured at a narrow tree; in bf16 the trunk sits 1e-2 away, so it
  fails TRUNK_TOL by three orders of magnitude;
* dropping the shift mask or the relative-position bias moves the memory
  by more than 1e-2 of its max at these weights (bias tables +-1), three
  orders over TRUNK_TOL;
* the whole model's teacher-forced logits at the published widths
  (swin3d_b, 1024-wide memory into K2 and the decoder) within LOGIT_TOL
  of their max: that rounding through the decoder's LSTM and attention.
"""

import json

import numpy as np
import pytest
import torch

from mmqg_tpu_torch import convert
from mmqg_tpu_torch import decode as DEC
from mmqg_tpu_torch.compat import from_torchvision as TV
from mmqg_tpu_torch.models import qg_model as TQ
from mmqg_tpu_torch.models import video_swin as S
from mmqg_tpu_torch.pipeline import QGPipeline
from portbench import gen
from portbench.reference import inputs as RI
from portbench.reference import swin3d as RS
from portbench.reference.model import START
from portbench.run import HERE

torch.set_num_threads(1)
TRUNK_TOL = 1e-5
LOGIT_TOL = 1e-5
NARROW = {"embed_dim": 32, "depths": (2, 2, 2, 2), "heads": (1, 2, 4, 8)}
# the benchmark's configuration, cut to a CPU size
TINY = {"n_vocab": 60, "word_emb_dim": 8, "hidden_dim": 16,
        "text_layers": 2, "dec_layers": 2, "audio_emb_dim": 8,
        "context_max_length": 24, "av_max_length": 24, "target_steps": 6,
        "mel_frames": 16, "mel_bins": 16, "sample_rate": 1600,
        "stft_window": 64, "stft_hop": 32}


def _cfg(size, width):
    cfg = json.loads((HERE / "configs" / "trimodal_attn_swin3d_b.json")
                     .read_text())
    cfg.update(TINY, frame_size=size, video_hidden_dim=width)
    return cfg


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _clips(cfg, frames, length):
    """The normalised clips as ``qg_model._video`` gives them to the trunk,
    padded to ``length`` frames, and their live temporal tokens."""
    mean, std = torch.tensor(cfg["vid_mean"]), torch.tensor(cfg["vid_std"])
    x = torch.zeros((len(frames), length) + frames[0].shape[1:])
    for i, f in enumerate(frames):
        x[i, :len(f)] = (torch.tensor(f).float() / 255.0 - mean) / std
    return x, S.temporal_out_len(torch.tensor([len(f) for f in frames]))


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.fixture(scope="module", params=[64, 96])
def narrow(request):
    """A narrow tree at 64 px (stage 3 4 x 4: the window clamped to the
    axis, the bias from the first rows of the (8, 7, 7) index) or 96 px
    (stage 1 24 x 24 and stage 2 12 x 12 padded to the window, stage 3
    6 x 6 clamped); two clips of 20 and 9 frames: 10 temporal tokens,
    shifted by 4 in odd blocks, and 5 live of them."""
    size = request.param
    cfg = _cfg(size, 8 * NARROW["embed_dim"])
    params, state = RS.make(cfg, 2**33 + 5, "cpu", **NARROW)
    rng = np.random.RandomState(4)
    frames = [rng.randint(0, 256, (n, size, size, 3)).astype(np.uint8)
              for n in (20, 9)]
    ref = RS.Swin3DReference(cfg, params, state, "cpu")
    with torch.no_grad():
        want, lens = ref.video(frames)
    return dict(cfg=cfg, params=params, frames=frames, want=want, lens=lens)


def _port(s, dtype=torch.float32, length=20, rows=None):
    model = S.build(s["params"]["video_enc"], torch.tensor)
    frames = s["frames"] if rows is None else [s["frames"][i] for i in rows]
    x, live = _clips(s["cfg"], frames, length)
    with torch.no_grad():
        return model, model.temporal(x, live, dtype=dtype)


def test_trunk_matches_the_plain_reference(narrow):
    _, got = _port(narrow)
    assert got.shape == narrow["want"].shape == (2, 10, 256)
    assert narrow["lens"].tolist() == [10, 5]
    assert _rel(got, narrow["want"]) <= TRUNK_TOL
    assert float(got[1, 5:].abs().max()) == 0.0      # past the live steps


def test_a_bf16_trunk_fails_the_tolerance(narrow):
    _, got = _port(narrow, torch.bfloat16)
    assert _rel(got, narrow["want"]) > 100 * TRUNK_TOL


def test_a_dropped_shift_mask_fails_the_tolerance(narrow, monkeypatch):
    region = S._region_mask
    monkeypatch.setattr(S, "_region_mask", lambda *a: region(*a) * 0)
    _, got = _port(narrow)
    assert _rel(got, narrow["want"]) > 100 * TRUNK_TOL


def test_a_dropped_bias_fails_the_tolerance(narrow):
    model = S.build(narrow["params"]["video_enc"], torch.tensor)
    for m in model.modules():
        if isinstance(m, S.Block):
            m.rel_bias.zero_()
    x, live = _clips(narrow["cfg"], narrow["frames"], 20)
    with torch.no_grad():
        got = model.temporal(x, live, dtype=torch.float32)
    assert _rel(got, narrow["want"]) > 100 * TRUNK_TOL


def test_a_clips_memory_does_not_depend_on_its_bucket(narrow):
    """The 9-frame clip alone at 18 frames (9 temporal tokens, over the
    window's 8) and in the batch at 20: the same live memory, and the
    20-frame clip's at 20 and 26."""
    _, alone = _port(narrow, length=18, rows=[1])
    _, batch = _port(narrow, length=20)
    _, longer = _port(narrow, length=26)
    assert _rel(alone[0, :5], batch[1, :5]) <= TRUNK_TOL
    assert _rel(longer[:, :10], batch) <= TRUNK_TOL


def test_whole_model_logits_at_the_published_widths():
    """swin3d_b at its widths and depth on two clips of 24 and 7 frames at
    32 x 32, its 1024-wide memory into the attention decoder:
    teacher-forced logits of the port's encode and decoder against
    ``Swin3DReference.logits`` on the same served tokens."""
    cfg = _cfg(32, 1024)
    params, state = RS.make(cfg, 2**33 + 9, "cpu")
    vocab, i2w = gen.vocab(cfg["n_vocab"])
    mc = TQ.ModelConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                           for k, v in cfg.items()
                           if k in TQ.ModelConfig._fields})
    pipe = QGPipeline(None, mc, params, state, vocab, i2w, device="cpu",
                      dtype=torch.float32)
    rng = np.random.RandomState(5)
    contexts = [" ".join(f"w{i}" for i in rng.randint(3, 60, n))
                for n in (7, 19)]
    frames = [rng.randint(0, 256, (n, 32, 32, 3)).astype(np.uint8)
              for n in (24, 7)]
    audio = [rng.randint(-3000, 3000, n).astype(np.int16)
             for n in (1600, 2900)]
    tokens = [[5, 9, 2], [7, 3, 11, 4, 2]]
    host = pipe._pack(contexts, frames, audio)
    batch = pipe._to_device(host)
    fcap = DEC.frames_bucket(mc, host["frames_len"])
    acap = DEC.audio_bucket(mc, host["audio_len"])
    with torch.no_grad():
        mem, st = DEC.encode(pipe.model, mc, batch, frames_cap=fcap,
                             audio_cap=acap, dtype=torch.float32)
        assert mem.enc_video.shape == (2, 24, 1024)
        assert mem.video_len.tolist() == [12, 4]
        inputs = torch.zeros((2, 5), dtype=torch.long)
        inputs[:, 0] = START
        for i, t in enumerate(tokens):
            inputs[i, 1:len(t)] = torch.tensor(t[:-1])
        got = pipe.model.decoder.teacher_forced_logits(
            pipe.model.embedding, inputs, mem, st, dtype=torch.float32)
        ref = RS.Swin3DReference(cfg, params, state, "cpu")
        ids = [RI.context_ids(c, vocab, mc.context_max_length)[0]
               for c in contexts]
        want = ref.logits(ids, frames, audio, tokens)
    for i, t in enumerate(tokens):
        assert _rel(got[i, :len(t)], want[i]) <= LOGIT_TOL, i
    with pytest.raises(NotImplementedError, match="stochastic depth"):
        TQ.encode(pipe.model, mc, batch, train=True, dtype=torch.float32)


def test_the_published_layout():
    """``init_params`` with ``video_encoder: swin3d`` draws torchvision's
    ``swin3d_b``: 87,638,984 trunk parameters and no state; the
    reference's modules have as many, and 88,048,984 with the 400-class
    head; the benchmark's weights the same shapes."""
    mc = TQ.ModelConfig(n_vocab=20, mode="text_video",
                        video_encoder="swin3d", video_hidden_dim=1024)
    params, state = TQ.init_params(mc, 0)
    trunk = params["video_enc"]
    assert sum(a.size for a in _leaves(trunk)) == 87638984
    assert state["video_enc"] == {}
    assert [len(s) for s in trunk["stages"]] == [2, 2, 18, 2]
    assert trunk["stages"][3][1]["rel_bias"].shape == (2535, 32)
    count = lambda net: sum(p.numel() for p in net.parameters())
    assert count(RS.swin3d()) == 87638984
    assert count(RS.swin3d(num_classes=400)) == 88048984
    assert sum(int(np.prod(shape)) for _, shape, _, _ in RS.layout()) == \
        87638984
    with pytest.raises(ValueError, match="1024-wide"):
        TQ.init_params(mc._replace(video_hidden_dim=512), 0)


def test_the_converter_reads_and_writes_the_released_layout():
    """The reference module's own ``state_dict`` (torchvision's names and
    shapes) imports to the benchmark's tree and exports back to itself; a
    tensor of another shape, a missing one or a stranger is refused by
    name."""
    cfg = _cfg(32, 1024)
    params, _ = RS.make(cfg, 2**33 + 11, "cpu")
    net = RS.swin3d("cpu")
    net.load_state_dict(RS.state_dict_of(_torch_tree(params["video_enc"])))
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    assert set(sd) == {k for k, _ in TV.swin3d_shapes(num_classes=None)}
    got, state = TV.import_video_swin(sd)
    assert state == {}
    for a, b in zip(_leaves(got), _leaves(params["video_enc"])):
        assert a.shape == b.shape and np.array_equal(a, b)
    back = TV.export_video_swin(got)
    assert set(back) == set(sd)
    assert all(np.array_equal(back[k], sd[k]) for k in sd)
    head = dict(sd, **{"head.weight": np.zeros((400, 1024), np.float32),
                       "head.bias": np.zeros(400, np.float32)})
    TV.import_video_swin(head)                       # the head is dropped
    key = "features.4.3.attn.qkv.weight"
    with pytest.raises(ValueError, match=f"{key} has shape"):
        TV.import_video_swin(dict(sd, **{key: sd[key][:-1]}))
    with pytest.raises(ValueError, match="norm.bias is missing"):
        TV.import_video_swin({k: v for k, v in sd.items()
                              if k != "norm.bias"})
    with pytest.raises(ValueError, match="features.6.2.norm1.weight"):
        TV.import_video_swin(dict(sd, **{
            "features.6.2.norm1.weight": sd["norm.weight"]}))


def test_swin3d_weights_on_another_encoders_config_are_refused(tmp_path):
    from mmqg_tpu_torch.config import Config

    path = Config(output_path=tmp_path / "out").save(tmp_path / "c.json")
    with pytest.raises(SystemExit, match="only fit video_encoder: 'swin3d'"):
        convert.convert(path, None, None, "x", verify_hash=False,
                        device="cpu", swin3d=tmp_path / "none.pth")


def test_swin3d_weights_need_their_own_frame_statistics(tmp_path):
    """The released weights expect frames normalised with ImageNet's
    statistics: a swin3d config with the R(2+1)D configuration's Kinetics
    ones (``Config``'s defaults) is refused, and the benchmark's
    configuration has the weights' own."""
    from mmqg_tpu_torch.config import Config

    path = Config(output_path=tmp_path / "out", video_encoder="swin3d",
                  video_hidden_dim=1024).save(tmp_path / "c.json")
    with pytest.raises(SystemExit, match="vid_mean .* expect mean"):
        convert.convert(path, None, None, "x", verify_hash=False,
                        device="cpu", swin3d=tmp_path / "none.pth")
    cfg = _cfg(32, 1024)
    assert tuple(cfg["vid_mean"]) == S.MEAN
    assert tuple(cfg["vid_std"]) == S.STD


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    return torch.as_tensor(tree)
