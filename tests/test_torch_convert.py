"""The port's released-weights converter (``python -m
mmqg_tpu_torch.convert``) against the JAX package's
(``scripts/convert_released_weights.py``): ``--dry-run`` end to end on the
CPU, its imported VGGish and R(2+1)D-18 subtrees against what the JAX
loaders make of the same state dicts, the restore through
``Trainer.resume``, and the sha256 and ``--resnet`` errors."""

import contextlib
import importlib.util
import io
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from mmqg_tpu.compat.torch_import import load_pretrained_video_resnet
from mmqg_tpu.models import audio_encoder as JA
from mmqg_tpu_torch import checkpoint as ckpt
from mmqg_tpu_torch import convert
from mmqg_tpu_torch.config import Config
from mmqg_tpu_torch.train import Trainer

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "convert_released_weights",
        REPO / "scripts" / "convert_released_weights.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    """``convert --dry-run --device cpu`` into a work directory: its
    config, stand-in .pth files and the 'pretrained' checkpoint."""
    root = tmp_path_factory.mktemp("dry")
    resumed = []
    real = Trainer.resume
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(
            io.StringIO()) as out:
        mp.setattr(Trainer, "resume", lambda self, alias="last": (
            resumed.append(alias), real(self, alias))[1])
        convert.main(["--dry-run", "--device", "cpu", "--work-dir",
                      str(root)])
    yield {"root": root, "out": out.getvalue(), "resumed": resumed}
    shutil.rmtree(root)  # ~0.8 GB of stand-ins and checkpoint


def _sd(path):
    return {k: v.numpy() for k, v in
            torch.load(path, map_location="cpu", weights_only=True).items()}


def _plain(tree):
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    return np.asarray(tree)


def _assert_equal_trees(got, ref, path=""):
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref), path
        for k in ref:
            _assert_equal_trees(got[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, list):
        assert len(got) == len(ref), path
        for i, (a, b) in enumerate(zip(got, ref)):
            _assert_equal_trees(a, b, f"{path}[{i}]")
    else:
        a, b = np.asarray(got), np.asarray(ref)
        assert a.shape == b.shape, path
        assert np.array_equal(a.astype(np.float32), b.astype(np.float32)), path


def test_dry_run_subtrees_equal_the_jax_loaders(dry):
    """The checkpoint's audio_enc and video_enc are what JAX's
    load_vggish_state_dict and load_pretrained_video_resnet make of the
    stand-in files; its metadata names both imports."""
    config = Config.load(dry["root"] / "results" / "config.json")
    state = ckpt.load_checkpoint(config.checkpoint_dir, "pretrained")
    meta = ckpt.load_metadata(config.checkpoint_dir, "pretrained")
    assert meta["pretrained"] == ["vggish", "r2plus1d_18"]
    params, mstate = state["params"], state["model_state"]
    vggish = _sd(dry["root"] / "vggish-standin.pth")
    ref_audio = JA.load_vggish_state_dict(params["audio_enc"], vggish)
    _assert_equal_trees(params["audio_enc"], _plain(ref_audio))
    # audio leaves are the stand-in's weights, transposed
    w = vggish["features.3.weight"]
    assert np.array_equal(params["audio_enc"]["convs"][1]["w"],
                          w.transpose(2, 3, 1, 0))
    resnet = _sd(dry["root"] / "r2plus1d_18-standin.pth")
    ref_p, ref_s = load_pretrained_video_resnet(params, mstate, resnet)
    _assert_equal_trees(params["video_enc"], _plain(ref_p["video_enc"]))
    _assert_equal_trees(mstate["video_enc"], _plain(ref_s["video_enc"]))
    # the stand-in's keys are torchvision's
    assert {"stem.0.weight", "layer4.1.conv2.0.3.weight",
            "layer2.0.downsample.1.running_var", "fc.bias"} <= set(resnet)


def test_dry_run_checkpoint_restores_through_trainer_resume(dry):
    """The dry run restored its checkpoint through Trainer.resume (and held
    the restored audio_enc to the stand-in's weights, or it would have
    raised)."""
    assert dry["resumed"] == ["pretrained"]
    assert "dry run OK: conversion + checkpoint round trip" in dry["out"]
    assert "imported: vggish, r2plus1d_18" in dry["out"]


def test_wrong_sha256_prefix_raises_as_jax(dry, capsys):
    cfg = dry["root"] / "results" / "config.json"
    vggish = dry["root"] / "vggish-standin.pth"
    with pytest.raises(SystemExit) as mine:
        convert.main(["--config", str(cfg), "--vggish", str(vggish),
                      "--device", "cpu"])
    with pytest.raises(SystemExit) as theirs:
        _jax_script()._check_sha(vggish, "vggish")
    assert str(mine.value) == str(theirs.value)
    assert "expected prefix 10086976" in str(mine.value)


def test_resnet_on_a_conv_lstm_config_raises_as_jax(dry, tmp_path):
    config = Config.load(dry["root"] / "results" / "config.json")
    path = config.replace(video_encoder="conv_lstm").save(
        tmp_path / "config.json")
    want = ("--resnet given but the config's video_encoder is 'conv_lstm'; "
            "the R(2+1)D weights only fit video_encoder: 'resnet' "
            "(reference model/encoder.py:24)")
    with pytest.raises(SystemExit) as mine:
        convert.main(["--config", str(path), "--resnet",
                      str(dry["root"] / "r2plus1d_18-standin.pth"),
                      "--no-verify-hash", "--device", "cpu"])
    assert str(mine.value) == want
    # the JAX script's text, piece by piece of its f-string
    script = (REPO / "scripts" / "convert_released_weights.py").read_text()
    for piece in ("--resnet given but the config's video_encoder is ",
                  "; the R(2+1)D weights only fit ",
                  "video_encoder: 'resnet' (reference model/encoder.py:24)"):
        assert piece in script


def test_a_released_resnet_of_other_widths_is_refused(dry, monkeypatch):
    """The released layout loads: the stand-in has torchvision's shapes
    (conv2 of layer2.0 230 wide, the block's one midplanes) and passes the
    check. A state dict whose shapes do not fit the model's R(2+1)D-18
    (here the JAX package's 288-wide conv2, midplanes(planes, planes))
    stops the conversion, naming the tensor, before any checkpoint is
    written."""
    path = dry["root"] / "r2plus1d_18-standin.pth"
    sd = _sd(path)
    w = sd["layer2.0.conv2.0.0.weight"]
    assert w.shape == (230, 128, 1, 3, 3)
    convert._check_resnet_shapes(sd)
    sd["layer2.0.conv2.0.0.weight"] = np.zeros((288,) + w.shape[1:],
                                               np.float32)
    monkeypatch.setattr(convert, "_load_state_dict", lambda p: sd)
    with pytest.raises(SystemExit, match=r"resnet: layer2\.0\.conv2\.0\.0"
                                         r"\.weight has shape \(288, 128, 1, 3, 3\), "
                                         r"the model's R\(2\+1\)D-18 takes "
                                         r"\(230, 128"):
        convert.convert(dry["root"] / "results" / "config.json", None, path,
                        alias="bad", verify_hash=False, device="cpu")
    config = Config.load(dry["root"] / "results" / "config.json")
    assert not ckpt.has_checkpoint(config.checkpoint_dir, "bad")


def test_convert_needs_the_card_unless_asked_for_the_cpu(dry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        convert.convert(dry["root"] / "results" / "config.json",
                        dry["root"] / "vggish-standin.pth", None, alias="x",
                        verify_hash=False)


def test_standin_shapes_are_the_port_layout():
    """The stand-in VGGish has the released file's shapes; the R(2+1)D-18
    one the names and shapes torchvision saves, which are the port's tree:
    31,505,325 parameters with the 400-class head, torchvision's count."""
    shapes = dict(convert.vggish_shapes())
    assert shapes["embeddings.0.weight"] == (4096, 12288)
    assert len(shapes) == 18
    rs = dict(convert.r2plus1d_18_shapes())
    assert rs["stem.0.weight"] == (45, 3, 1, 7, 7)
    assert rs["layer2.0.conv1.0.0.weight"] == (230, 64, 1, 3, 3)
    for layer, cin, mid in ((2, 128, 230), (3, 256, 460), (4, 512, 921)):
        assert rs[f"layer{layer}.0.conv2.0.0.weight"] == (mid, cin, 1, 3, 3)
        assert rs[f"layer{layer}.0.conv2.0.3.weight"] == (cin, mid, 3, 1, 1)
    n = sum(int(np.prod(s)) for k, s in rs.items()
            if not k.endswith(("running_mean", "running_var",
                               "num_batches_tracked")))
    assert n == 31505325
