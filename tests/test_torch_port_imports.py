"""The port's own copies of the JAX package's JAX-free modules (``config``,
``metrics``, ``data.dataset``, ``data.wav``, ``data.vocab``,
``data.text_prep``, ``data.subtitles``, ``data.saliency``,
``utils.pipelining``) against the originals, and that importing every
module of the port, and ``chip_smoke``, loads nothing of ``jax`` or of the
JAX package ``mmqg_tpu``."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mmqg_tpu import metrics as JM
from mmqg_tpu.config import Config as JaxConfig
from mmqg_tpu.data import saliency as JS
from mmqg_tpu.data import subtitles as JSUB
from mmqg_tpu.data import text_prep as JT
from mmqg_tpu.data import wav as JW
from mmqg_tpu.data.dataset import QGDataset as JaxDataset
from mmqg_tpu.pipeline import QGPipeline as JaxPipeline
from mmqg_tpu.utils.pipelining import pipelined as jax_pipelined
from mmqg_tpu_torch import metrics as M
from mmqg_tpu_torch.config import Config
from mmqg_tpu_torch.data import saliency as S
from mmqg_tpu_torch.data import subtitles as SUB
from mmqg_tpu_torch.data import text_prep as T
from mmqg_tpu_torch.data import wav as W
from mmqg_tpu_torch.data.dataset import QGDataset
from mmqg_tpu_torch.pipeline import QGPipeline
from mmqg_tpu_torch.utils.pipelining import pipelined

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("writer,reader", [(JaxConfig, Config),
                                           (Config, JaxConfig)])
def test_config_json_round_trip_between_packages(tmp_path, writer, reader):
    """Each package reads the config.json the other writes: every field,
    with a non-default value, survives, paths included."""
    cfg = writer(output_path=tmp_path / "out", data_path=tmp_path / "data",
                 batch_size=7, lr=3e-3, vid_mean=(0.1, 0.2, 0.3),
                 mesh_shape=(2, 4), context_max_length=99, best_epoch=5,
                 lr_schedule="cosine", audio_sample_rate=8000)
    path = cfg.save()
    assert path == tmp_path / "out" / "config.json"
    back = reader.load(path)
    assert back.to_dict() == cfg.to_dict()
    assert back.output_path == tmp_path / "out" and back.mesh_shape == (2, 4)
    # the reference's spelling of context_max_length is honoured on load
    assert reader.from_dict({"context_max_lenth": 17}).context_max_length == 17
    assert back.replace(lr=1.0).lr == 1.0 and back.lr == 3e-3


@pytest.mark.parametrize("question,pred", [
    ("what is the state of the system", "what is the state of a system"),
    ("how does the model change", "how does the model change over time"),
    ("why", "when is it"),
    ("what is the value", ""),
    ("", "what"),
])
@pytest.mark.parametrize("compat", [False, True])
def test_bleu_suite_matches_jax(question, pred, compat):
    got = M.bleu_suite(question, pred.split(), compat=compat)
    ref = JM.bleu_suite(question, pred.split(), compat=compat)
    assert got == ref and set(got) == set(M.BLEU_WEIGHTS)


@pytest.mark.parametrize("batch_size,shuffle,load_media",
                         [(4, False, True), (5, True, True), (3, True, False)])
def test_dataset_batches_equal_jax(tiny_config, tiny_corpus, batch_size,
                                   shuffle, load_media):
    """The port's QGDataset yields the JAX package's batches byte for byte
    (media read with numpy and the port's WAV reader; the JAX package uses
    its C++ packer where it is built)."""
    kw = dict(load_media=load_media)
    ref = JaxDataset(tiny_config, tiny_config.train_file, **kw)
    got = QGDataset(tiny_config, tiny_config.train_file, **kw)
    assert len(got) == len(ref) and got.vocab == ref.vocab
    if load_media:
        assert got.audio_len.max() > 0 and got.frames_len.max() > 1
    rngs = [np.random.default_rng(3) if shuffle else None for _ in range(2)]
    gb = list(got.batches(batch_size, shuffle=shuffle, rng=rngs[0]))
    rb = list(ref.batches(batch_size, shuffle=shuffle, rng=rngs[1]))
    assert len(gb) == len(rb) == -(-len(ref) // batch_size)
    for g, r in zip(gb, rb):
        assert g.questions == r.questions and g.size == r.size
        for k in ("context_ids", "context_len", "frames", "frames_len",
                  "audio_pcm", "audio_len", "target_ids", "target_len",
                  "question_id", "valid"):
            a, b = getattr(g, k), getattr(r, k)
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert a.tobytes() == b.tobytes(), k


def test_pipelined_order_and_lag_match_jax():
    for lag in (0, 1, 2, 5):
        events = {}
        for name, fn in (("port", pipelined), ("jax", jax_pipelined)):
            log = []

            def dispatch(x):
                log.append(("d", x))
                return x * 10

            def finalize(d, x):
                log.append(("f", x))
                return d + x
            out = list(fn(range(4), dispatch, finalize, lag=lag))
            assert out == [0, 11, 22, 33]
            events[name] = log
        assert events["port"] == events["jax"]
        # dispatch runs at most ``lag`` items ahead of finalize
        ahead = min(lag + 1, 4)
        assert events["port"][:ahead] == [("d", i) for i in range(ahead)]
        assert events["port"][ahead] == ("f", 0)
    with pytest.raises(ValueError):
        list(pipelined([1], lambda x: x, lambda d, x: d, lag=-1))


_SRT = "1\n00:00:01,500 --> 00:00:04,000\nIt's THE value\n\n2\nbad\n"
_VTT = "WEBVTT\n\n00:02.000 --> 00:05.000 line:0\nWe'll see\n"


@pytest.mark.parametrize("name,args", [
    ("decontract", ("won't can't let's isn't they’re I’d we'll ’ve I'm",)),
    ("tokenize", ("a-b, c's 3.5 x_y? ¡ñ!",)),
    ("preprocess_text", ("Gradient—descent: it's 2.5x faster, isn't it?",)),
    ("preprocess_text", ("_-—",)),
    ("lowercase_subtitle", (" Two\nLINES ",)),
    ("span_seconds", ("12:07",)),
    ("is_important", (1.0, 2.0, 1.5, 9.0)),
    ("is_important", (1.0, 2.0, 2.5, 9.0)),
    ("parse_srt", (_SRT,)),
    ("parse_vtt", (_VTT,)),
    ("parse_span_ms", ("0:07", "1:02")),
    ("is_salient", (999.9, 1000, 2000)),
    ("clip_span", (np.arange(50, dtype=np.int16), 10, 1.26, 3.0)),
    ("_row_seed", (65535, 65535)),
])
def test_copied_host_functions_equal_the_originals(name, args):
    """Each function copied from the JAX package's host modules gives the
    original's result on the same input."""
    for port_mod, jax_mod in ((T, JT), (SUB, JSUB), (S, JS), (W, JW),
                              (QGPipeline, JaxPipeline)):
        if hasattr(port_mod, name):
            got = getattr(port_mod, name)(*args)
            ref = getattr(jax_mod, name)(*args)
            break
    else:
        raise AssertionError(f"{name} is not in the port")
    if isinstance(ref, np.ndarray):
        assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes()
    elif isinstance(ref, list) and ref and hasattr(ref[0], "start"):
        assert [vars(c) for c in got] == [vars(c) for c in ref]
    else:
        assert got == ref


def test_port_and_chip_smoke_import_nothing_of_jax():
    """Every module of mmqg_tpu_torch (walked with pkgutil) and chip_smoke,
    imported in a fresh interpreter, leave no ``jax`` and no ``mmqg_tpu``
    or ``mmqg_tpu.*`` module in sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import mmqg_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "mmqg_tpu_torch.__path__, 'mmqg_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'mmqg_tpu')]\n"
        "need = {'mmqg_tpu_torch.serve', 'mmqg_tpu_torch.data.native', "
        "'mmqg_tpu_torch.data.saliency', 'mmqg_tpu_torch.data.subtitles', "
        "'mmqg_tpu_torch.data.text_prep', "
        "'mmqg_tpu_torch.models.video_resnet', "
        "'mmqg_tpu_torch.compat.from_torchvision', "
        "'mmqg_tpu_torch.parallel.mesh', 'mmqg_tpu_torch.parallel.multihost', "
        "'mmqg_tpu_torch.parallel.replicas', "
        "'mmqg_tpu_torch.data.streaming'}\n"
        "print(len(names), bad, need - set(names))\n"
        "sys.exit(1 if bad or need - set(names) or len(names) < 20 else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
