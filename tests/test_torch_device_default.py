"""The port's entry points run on the card unless the caller asks for the
CPU: ``QGPipeline``, ``QGPipeline.from_checkpoint`` and
``train.init_train_state`` default to ``device="cuda"`` and, without CUDA,
raise a RuntimeError naming ``device="cpu"``; with ``device="cpu"`` they
run on the CPU. ``torch.cuda.is_available`` is patched, so these tests
behave the same on a machine with a card."""

import inspect
import json
import shutil

import numpy as np
import pytest
import torch

from mmqg_tpu_torch import checkpoint as ckpt
from mmqg_tpu_torch.compat.from_jax import train_state_to_numpy
from mmqg_tpu_torch.models import qg_model
from mmqg_tpu_torch.optim import make_optimizer
from mmqg_tpu_torch.pipeline import QGPipeline
from mmqg_tpu_torch.train import init_train_state
from mmqg_tpu_torch.utils.device import resolve_device

N_VOCAB = 30


@pytest.fixture(scope="module")
def saved(tiny_config, tmp_path_factory):
    """A tiny model's train state, written by the port's checkpoint writer
    with its vocabulary files: (config, mc, params, state)."""
    root = tmp_path_factory.mktemp("device_default")
    cfg = tiny_config.replace(output_path=root / "results",
                              data_path=root / "data").ensure_dirs()
    mc = qg_model.ModelConfig.from_config(cfg, n_vocab=N_VOCAB,
                                          mode="trimodal")
    params, state = qg_model.init_params(mc, 3)
    words = ["<pad>", "<start>", "<end>"] + [f"w{i}" for i in
                                             range(3, N_VOCAB)]
    with open(cfg.vocab_file, "w") as f:
        json.dump({w: i for i, w in enumerate(words)}, f)
    with open(cfg.index_to_word_file, "w") as f:
        json.dump({str(i): w for i, w in enumerate(words)}, f)
    opt = make_optimizer(cfg)
    ts = init_train_state(mc, None, opt, seed=3, device="cpu")
    ckpt.save_checkpoint(cfg.checkpoint_dir, "best",
                         train_state_to_numpy(ts.model, ts.opt_state, 0))
    yield cfg, mc, params, state
    shutil.rmtree(root)  # ~0.3 GB: the suite keeps every tmp dir to its end


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _entry(name, saved):
    """A call of the entry point ``name``; its keywords (``device``) are
    passed on."""
    cfg, mc, params, state = saved
    vocab = {f"w{i}": i for i in range(N_VOCAB)}
    i2w = {str(i): w for w, i in vocab.items()}
    if name == "QGPipeline":
        return lambda **kw: QGPipeline(cfg, mc, params, state, vocab, i2w,
                                       dtype=torch.float32, **kw)
    if name == "from_checkpoint":
        return lambda **kw: QGPipeline.from_checkpoint(
            cfg, alias="best", dtype=torch.float32, **kw)
    return lambda **kw: init_train_state(mc, None, make_optimizer(cfg),
                                         seed=3, **kw)


ENTRIES = ("QGPipeline", "from_checkpoint", "init_train_state")


@pytest.mark.parametrize("name", ENTRIES)
def test_no_device_without_cuda_raises_naming_cpu(saved, no_cuda, name):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _entry(name, saved)()


@pytest.mark.parametrize("name", ENTRIES)
def test_explicit_cuda_without_cuda_raises(saved, no_cuda, name):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry(name, saved)(device="cuda")


@pytest.mark.parametrize("name", ENTRIES)
def test_cpu_when_asked(saved, no_cuda, name):
    out = _entry(name, saved)(device="cpu")
    devices = {p.device.type for p in out.model.parameters()}
    assert devices == {"cpu"}


@pytest.mark.parametrize("fn", [QGPipeline.__init__,
                                QGPipeline.from_checkpoint,
                                init_train_state])
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_resolve_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(caller="x") == torch.device("cuda")
    assert resolve_device("cuda:1", caller="x") == torch.device("cuda", 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu", caller="x") == torch.device("cpu")
    with pytest.raises(RuntimeError, match=r"^x: device 'cuda'"):
        resolve_device(caller="x")


def test_cpu_pipeline_matches_train_state_checkpoint(saved, no_cuda):
    """The checkpoint loaded on the CPU holds the weights that were saved."""
    cfg, mc, _, _ = saved
    pipe = QGPipeline.from_checkpoint(cfg, alias="best", device="cpu",
                                      dtype=torch.float32)
    ts = init_train_state(mc, None, make_optimizer(cfg), seed=3,
                          device="cpu")
    got, ref = pipe.model.state_dict(), ts.model.state_dict()
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), ref[k].numpy())
