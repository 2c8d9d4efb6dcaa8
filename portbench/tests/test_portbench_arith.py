"""The yardstick's FLOP and byte arithmetic against hand counts, and the
AV buckets the readers assume against the ones the port packs."""

import json

import numpy as np
import pytest
import torch

from mmqg_tpu_torch import decode as DEC
from mmqg_tpu_torch.models import qg_model
from mmqg_tpu_torch.pipeline import QGPipeline
from portbench import arith, gen, weights
from portbench.tests.conftest import PKG, TINY, TINY_MIX
from portbench.traffic import serve_bulk


def test_bound_takes_the_larger_side():
    assert arith.bound_s(989e12, 0, "bf16") == pytest.approx(1.0)
    assert arith.bound_s(0, 3.35e12, "bf16") == pytest.approx(1.0)
    assert arith.bound_s(1979e12, 6.7e12, "int8") == pytest.approx(2.0)


def test_lstm_layer_counts():
    # B=2, T=3, In=4, H=8: 2*B*T*4H*(In+H) + 10*B*T*H operations
    c = arith.lstm_layer(2, 3, 4, 8)
    assert c["ops"] == 2 * 2 * 3 * 32 * 12 + 10 * 2 * 3 * 8 == 5088
    # bf16 x, wx, wh; f32 b, outputs, h0, c0, h_last, c_last
    assert c["bytes"] == 2 * (24 + 128 + 256) + 4 * 32 + 4 * 48 + 4 * 64


def test_vggish_flops_by_hand():
    convs = [96 * 64 * 9 * 1 * 64, 48 * 32 * 9 * 64 * 128,
             24 * 16 * 9 * 128 * 256, 24 * 16 * 9 * 256 * 256,
             12 * 8 * 9 * 256 * 512, 12 * 8 * 9 * 512 * 512]
    fcs = [6 * 4 * 512 * 4096, 4096 * 4096, 4096 * 128]
    assert arith.vggish_flops(3) == 3 * 2 * (sum(convs) + sum(fcs))
    assert arith.vggish_flops(1) == 1727791104


def test_int8_launches_by_hand():
    ls = arith.vggish_int8_launches(2)
    assert len(ls) == 10                       # 5 convs, 5 quantizes
    convs = [l for l in ls if l["ops"] > 1e8]
    assert sum(l["ops"] for l in convs) == 2 * 2 * (
        48 * 32 * 9 * 64 * 128 + 24 * 16 * 9 * 128 * 256
        + 24 * 16 * 9 * 256 * 256 + 12 * 8 * 9 * 256 * 512
        + 12 * 8 * 9 * 512 * 512)
    # conv2: int8 input and weights, f32 scales and bias, bf16 pooled out
    assert ls[1]["bytes"] == (2 * 48 * 32 * 64 + 9 * 64 * 128 + 12 * 128
                              + 4 * 2 + 2 * 2 * 24 * 16 * 128)
    # conv2's input quantize: bf16 in, int8 out
    assert ls[0]["bytes"] == 2 * 48 * 32 * 64 * 3


def test_video_and_request_flops_by_hand():
    v = 2 * (110 * 110 * 9 * 3 * 4 + 108 * 108 * 9 * 4 * 6
             + 34 * 34 * 9 * 6 * 8 + 32 * 32 * 9 * 8 * 10)
    assert arith.video_cnn_flops(1) == v
    cfg = json.loads((PKG / "configs" / "text_video_nonattn.json").read_text())
    H, D = 512, 300
    text = 5 * 2 * 4 * H * ((D + H) + 2 * (H + H))
    video = v * 7 + 7 * 2 * 4 * H * (1000 + H)
    step = (2 * 4 * H * ((D + 128 + 512 + H) + 2 * (H + H))
            + 2 * H * cfg["n_vocab"])
    assert arith.request_flops(cfg, 5, 7, 0, 3) == text + video + 3 * step


@pytest.mark.parametrize("name", ["trimodal_attn", "text_video_nonattn"])
def test_shapes_match_the_ports_buckets(name):
    cfg = json.loads((PKG / "configs" / f"{name}.json").read_text())
    cfg.update(TINY)
    mix = dict(json.loads((PKG / "mixes" / "bulk_b32.json").read_text()),
               **TINY_MIX["bulk_b32"])
    params, state = weights.make(cfg, 3, "cpu")
    vocab, i2w = gen.vocab(cfg["n_vocab"])
    mc = qg_model.ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                                 for k, v in cfg.items()
                                 if k in qg_model.ModelConfig._fields})
    pipe = QGPipeline(None, mc, params, state, vocab, i2w, device="cpu",
                      dtype=torch.float32)
    for batch in gen.bulk_pool(cfg, mix, 3, "cpu"):
        host = pipe._pack(*batch)
        s = serve_bulk.shapes(cfg, batch, dict(
            audio_cap=DEC.audio_bucket(mc, host["audio_len"]),
            frames_cap=DEC.frames_bucket(mc, host["frames_len"])))
        assert s["rows"] == host["context_ids"].shape[0]
        assert s["fcap"] == host["frames"].shape[1]
        assert s["frames"] == list(host["frames_len"][:s["n"]])
        assert s["text"] == list(host["context_len"][:s["n"]])
        if name == "trimodal_attn":
            assert s["examples"] == [int(x) for x in
                                     np.maximum(0, (host["audio_len"][:s["n"]]
                                                    - 400) // 160 + 1) // 96]


def test_lstm_train_layer_counts():
    # B=2, T=3, In=4, H=8
    k = arith.lstm_train_layer(2, 3, 4, 8)
    f = arith.lstm_layer(2, 3, 4, 8)
    assert k["fwd"]["ops"] == f["ops"]
    assert k["fwd"]["bytes"] == f["bytes"] + 4 * 2 * 3 * 5 * 8
    assert k["bwd"]["ops"] == 2 * 2 * 3 * 32 * (8 + 16) + 20 * 2 * 3 * 8
    assert k["bwd"]["bytes"] == (2 * (24 + 128 + 256) + 4 * 6 * (8 + 8 + 32 + 8)
                                 + 4 * (24 + 128 + 256 + 32 + 32))
