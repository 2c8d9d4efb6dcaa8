"""The port's R(2+1)D-18 against the benchmark's plain reference
(``portbench/reference/r2plus1d.py``: ``F.conv3d`` and eval batchnorm in
float32, nothing of the port), and the published layout.

Seeded random weights at torchvision's channel widths
(``r2plus1d.make``), clips of 2-9 frames at 32 x 32, f32 on the CPU:

* the trunk's memory (``qg_model._video``'s normalisation, padding and
  ``VideoResNet.temporal``) within TRUNK_TOL of the memory's max: the
  same 37 convs summed in other orders, 3.1e-7 measured;
* the whole model's teacher-forced logits (text LSTM, VGGish, the
  attention decoder over the trunk's memory) within LOGIT_TOL of their
  max: that rounding through the decoder's three LSTM layers and
  attention, 1.1e-6 to 1.2e-6 measured;
* a trunk run in bf16 sits 3e-3 of the max away, so it fails TRUNK_TOL
  by two orders of magnitude.
"""

import json

import numpy as np
import pytest
import torch

from mmqg_tpu_torch import decode as DEC
from mmqg_tpu_torch.models import qg_model as TQ
from mmqg_tpu_torch.models import video_resnet as R
from mmqg_tpu_torch.pipeline import QGPipeline
from portbench import gen
from portbench.reference import inputs as RI
from portbench.reference import r2plus1d as RR
from portbench.reference.model import START
from portbench.run import HERE

torch.set_num_threads(1)
TRUNK_TOL = 1e-5
LOGIT_TOL = 1e-5
# the benchmark's configuration, cut to a CPU size (every width of the
# trunk kept: the video memory is its 512)
TINY = {"n_vocab": 60, "word_emb_dim": 8, "hidden_dim": 16,
        "text_layers": 2, "dec_layers": 2, "audio_emb_dim": 8,
        "context_max_length": 24, "av_max_length": 16, "target_steps": 6,
        "frame_size": 32, "mel_frames": 16, "mel_bins": 16,
        "sample_rate": 1600, "stft_window": 64, "stft_hop": 32}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.fixture(scope="module")
def setup():
    cfg = json.loads((HERE / "configs" / "trimodal_attn_r2plus1d.json")
                     .read_text())
    cfg.update(TINY)
    params, state = RR.make(cfg, 2**33 + 7, "cpu")
    vocab, i2w = gen.vocab(cfg["n_vocab"])
    mc = TQ.ModelConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                           for k, v in cfg.items()
                           if k in TQ.ModelConfig._fields})
    pipe = QGPipeline(None, mc, params, state, vocab, i2w, device="cpu",
                      dtype=torch.float32)
    rng = np.random.RandomState(4)
    contexts = [" ".join(f"w{i}" for i in rng.randint(3, 60, n))
                for n in (7, 19)]
    frames = [rng.randint(0, 256, (n, 32, 32, 3)).astype(np.uint8)
              for n in (9, 2)]
    audio = [rng.randint(-3000, 3000, n).astype(np.int16)
             for n in (1600, 2900)]
    return dict(cfg=cfg, params=params, state=state, vocab=vocab, mc=mc,
                pipe=pipe, req=(contexts, frames, audio))


def _port_memory(s, dtype):
    """The port's video memory of the request's frames at their bucket."""
    host = s["pipe"]._pack(*s["req"])
    batch = s["pipe"]._to_device(host)
    fcap = DEC.frames_bucket(s["mc"], host["frames_len"])
    enc, lens, _ = TQ._video(s["pipe"].model, s["mc"],
                             batch["frames"][:, :fcap],
                             batch["frames_len"], train=False, dtype=dtype)
    return enc, lens, fcap


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


def test_trunk_matches_the_plain_reference(setup):
    enc, lens, fcap = _port_memory(setup, torch.float32)
    ref = RR.R2Plus1DReference(setup["cfg"], setup["params"],
                               setup["state"], "cpu", clip_frames=fcap)
    with torch.no_grad():
        want, want_lens = ref.video(setup["req"][1])
    assert fcap == 10 and enc.shape == want.shape == (2, 2, 512)
    assert lens.tolist() == want_lens.tolist() == [2, 1]
    assert _rel(enc, want) <= TRUNK_TOL


def test_a_bf16_trunk_fails_the_tolerance(setup):
    enc, _, fcap = _port_memory(setup, torch.bfloat16)
    ref = RR.R2Plus1DReference(setup["cfg"], setup["params"],
                               setup["state"], "cpu", clip_frames=fcap)
    with torch.no_grad():
        want, _ = ref.video(setup["req"][1])
    assert _rel(enc, want) > 100 * TRUNK_TOL


def test_whole_model_logits_match_the_plain_reference(setup):
    """Teacher-forced logits of the port's encode and attention decoder
    against ``R2Plus1DReference.logits`` on the same served tokens."""
    s = setup
    pipe, mc = s["pipe"], s["mc"]
    tokens = [[5, 9, 2], [7, 3, 11, 4, 2]]
    host = pipe._pack(*s["req"])
    batch = pipe._to_device(host)
    fcap = DEC.frames_bucket(mc, host["frames_len"])
    acap = DEC.audio_bucket(mc, host["audio_len"])
    with torch.no_grad():
        mem, st = DEC.encode(pipe.model, mc, batch, frames_cap=fcap,
                             audio_cap=acap, dtype=torch.float32)
        inputs = torch.zeros((2, 5), dtype=torch.long)
        inputs[:, 0] = START
        for i, t in enumerate(tokens):
            inputs[i, 1:len(t)] = torch.tensor(t[:-1])
        got = pipe.model.decoder.teacher_forced_logits(
            pipe.model.embedding, inputs, mem, st, dtype=torch.float32)
        ref = RR.R2Plus1DReference(s["cfg"], s["params"], s["state"], "cpu",
                                   clip_frames=fcap)
        contexts, frames, audio = s["req"]
        ids = [RI.context_ids(c, s["vocab"], mc.context_max_length)[0]
               for c in contexts]
        want = ref.logits(ids, frames, audio, tokens)
    for i, t in enumerate(tokens):
        assert _rel(got[i, :len(t)], want[i]) <= LOGIT_TOL, i


def test_the_published_layout():
    """``init_params`` with ``video_encoder: resnet`` draws torchvision's
    ``r2plus1d_18``: conv2 of the first block of stages 2-4 at 230, 460
    and 921 midplanes, 31,300,125 trunk parameters, 31,505,325 with a
    400-class head; the reference's weights have the same shapes."""
    mc = TQ.ModelConfig(n_vocab=20, mode="text_video",
                        video_encoder="resnet")
    params, state = TQ.init_params(mc, 0)
    trunk = params["video_enc"]
    for si, mid in ((1, 230), (2, 460), (3, 921)):
        conv2 = trunk["stages"][si][0]["conv2"]
        assert conv2["spatial"]["w"].shape[-1] == mid
        assert conv2["temporal"]["w"].shape[3] == mid
        assert state["video_enc"]["stages"][si][0]["conv2"]["bn_mid"][
            "mean"].shape == (mid,)
    assert sum(a.size for a in _leaves(trunk)) == 31300125
    head, _ = R.init_numpy(np.random.RandomState(0), embed_dim=400)
    assert sum(a.size for a in _leaves(head)) == 31505325
    shapes = {tuple(path[2:]): shape for path, shape, _, _ in RR.layout()
              if path[0] == "params"}
    assert sum(int(np.prod(s)) for s in shapes.values()) == 31300125
    assert shapes[("stages", 3, 0, "conv2", "spatial", "w")] == (
        1, 3, 3, 512, 921)
