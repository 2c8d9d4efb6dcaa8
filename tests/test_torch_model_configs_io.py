"""Every configuration of the model through checkpoints and serving,
against the JAX package: msgpack train states in both directions, and
``QGPipeline.generate`` and the train and evaluate CLIs on a configuration
other than the flagship (text_video, the non-attention decoder, R(2+1)D),
f32 on the CPU where the JAX side allows it, bf16 (both CLIs' default)
otherwise."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmqg_tpu import checkpoint as JC
from mmqg_tpu import evaluate as JE
from mmqg_tpu import train as JT
from mmqg_tpu.data.dataset import QGDataset as JaxDataset
from mmqg_tpu.models import qg_model as JQ
from mmqg_tpu_torch import checkpoint as ckpt
from mmqg_tpu_torch import evaluate as E
from mmqg_tpu_torch.compat.from_jax import (load_train_state,
                                            params_from_numpy,
                                            train_state_to_numpy)
from mmqg_tpu_torch.config import Config
from mmqg_tpu_torch.models import qg_model as TQ
from mmqg_tpu_torch.optim import make_optimizer
from mmqg_tpu_torch.train import main
from tests.test_torch_model_configs import CONFIGS, IDS, build, jax_params
from tests.torch_port_fixtures import walk

torch.set_num_threads(1)


@pytest.mark.parametrize("config", CONFIGS, ids=IDS)
def test_checkpoints_cross_load_byte_for_byte(tiny_config, tmp_path, config):
    """A train state of each configuration (plain SGD, whose optimizer
    state holds no copy of the parameters: R(2+1)D-18 has 31M of them, and
    Adam's state round trip is the flagship's, ``test_torch_train.py``):
    the port writes the JAX package's msgpack
    byte for byte, the JAX package restores it, and the port loads the JAX
    package's file into a model of the configuration with every leaf
    equal."""
    mc, tmc, params, state = build(*config)
    opt_cfg = tiny_config.replace(optim="sgd")
    ts = jax.tree.map(np.asarray, {
        "params": jax_params(params), "model_state": state,
        "opt_state": JT.make_optimizer(opt_cfg).init(jax_params(params)),
        "step": np.asarray(3, np.int32)})
    JC.save_checkpoint(tmp_path / "jax", "last", ts)
    model = params_from_numpy(params, state, trainable=True)
    opt = make_optimizer(opt_cfg)
    template = opt.init(TQ.param_tree(model))
    opt_state, step = load_train_state(
        model, ckpt.load_checkpoint(tmp_path / "jax", "last"), template)
    assert step == 3
    ckpt.save_checkpoint(tmp_path, "last",
                         train_state_to_numpy(model, opt_state, step))
    assert ((tmp_path / "last.msgpack").read_bytes()
            == (tmp_path / "jax" / "last.msgpack").read_bytes())
    restored, _ = JC.load_checkpoint(tmp_path, "last", ts)
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(ts)):
        np.testing.assert_array_equal(np.asarray(a), b)
    # into a fresh model of the configuration, every leaf as written
    other = params_from_numpy(*TQ.init_params(tmc, 9))
    load_train_state(other, ckpt.load_checkpoint(tmp_path, "last"),
                     template)
    want = ckpt.load_checkpoint(tmp_path / "jax", "last")
    for path, a, b in walk(TQ.param_tree(other), want["params"]):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=path)
    for path, a, b in walk(TQ.model_state(other), want["model_state"]):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=path)


# ----------------------------------------------- serving and the CLIs

@pytest.fixture(scope="module")
def resnet_setup(tiny_config, tiny_corpus, tmp_path_factory):
    """The tiny corpus with video_encoder resnet, a config file, and a
    text_video / non-attention / resnet checkpoint written by the JAX
    package."""
    out = tmp_path_factory.mktemp("configs")
    cfg = tiny_config.replace(output_path=out / "results",
                              video_encoder="resnet")
    cfg.ensure_dirs()
    path = out / "config.json"
    cfg.save(path)
    ds = JaxDataset(cfg, cfg.test_file)
    mc = JQ.ModelConfig.from_config(cfg, n_vocab=len(ds.vocab),
                                    mode="text_video", dec="non_attn")
    params, state = TQ.init_params(TQ.ModelConfig(**mc._asdict()), 4)
    ts = {"params": params, "model_state": state,
          "opt_state": JT.make_optimizer(cfg).init(params),
          "step": np.zeros((), np.int32)}
    JC.save_checkpoint(cfg.checkpoint_dir, "best",
                       jax.tree.map(np.asarray, ts))
    return cfg, path, mc, params, state, ds


def test_pipeline_generate_matches_jax(resnet_setup):
    """QGPipeline in text_video / non_attn / resnet, f32: the JAX
    pipeline's questions for greedy and sampled decoding."""
    import functools

    from mmqg_tpu import decode as JDEC
    from mmqg_tpu.pipeline import QGPipeline as JaxPipeline
    from mmqg_tpu_torch.pipeline import QGPipeline

    cfg, _, mc, params, state, ds = resnet_setup
    vocab, i2w = ds.vocab, ds.index_to_word
    rng = np.random.RandomState(2)
    fs = cfg.frame_size
    contexts = [" ".join(list(vocab)[3 + i:9 + i]) for i in range(3)]
    frames = [rng.randint(0, 256, (t, fs, fs, 3), np.uint8)
              for t in (1, 3, 2)]
    port = QGPipeline(cfg, TQ.ModelConfig(**mc._asdict()), params, state,
                      vocab, i2w, device="cpu", dtype=torch.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JDEC, "decode_batch",
                   functools.partial(JDEC.decode_batch, dtype=jnp.float32))
        ref = JaxPipeline(cfg, mc, params, state, vocab, i2w)
        for strategy in ("greedy", "sampling", "topp"):
            want = ref.generate(contexts, frames, None, strategy=strategy,
                                seed=3, row_seeds=[7, -2, 2**31 + 1])
            got = port.generate(contexts, frames, None, strategy=strategy,
                                seed=3, row_seeds=[7, -2, 2**31 + 1])
            assert got == want, strategy
    with pytest.raises(KeyError, match="audio_enc"):
        port.calibrate_audio_int8([np.zeros(2000, np.int16)])


def test_train_and_evaluate_clis_on_cpu(resnet_setup, capsys):
    """``train`` with --mode text_video --decoder non_attn --video-encoder
    resnet: one epoch on the tiny corpus, stats, checkpoints and a config
    snapshot that records the backbone; then ``evaluate -s greedy`` on the
    JAX-written checkpoint of that configuration writes the JAX CLI's
    predictions and BLEU."""
    cfg, path, *_ = resnet_setup
    base_cfg = Config.load(path).replace(video_encoder="conv_lstm")
    train_out = cfg.output_path.parent / "trained"
    base_path = base_cfg.replace(output_path=train_out).save(
        train_out / "config.json")
    main(["-c", str(base_path), "--mode", "text_video", "--decoder",
          "non_attn", "--video-encoder", "resnet", "--epochs", "1",
          "--device", "cpu"])
    assert "Done !" in capsys.readouterr().out
    snap = Config.load(train_out / "config.json")
    assert snap.video_encoder == "resnet"
    assert (snap.checkpoint_dir / "last.msgpack").exists()
    stats = json.loads(snap.stats_json_path.read_text())
    assert len(stats["train"]["loss"]) == 1
    assert np.isfinite(stats["val"]["loss"]).all()

    argv = ["-c", str(path), "-s", "greedy", "--best", "--mode",
            "text_video", "--decoder", "non_attn"]
    out = cfg.output_path / "best_predictions_greedy.json"
    ref_bleu = JE.main(argv)
    ref_printed = capsys.readouterr().out
    ref = json.loads(out.read_text())
    out.unlink()
    bleu = E.main(argv + ["--device", "cpu"])
    assert capsys.readouterr().out == ref_printed
    assert json.loads(out.read_text()) == ref and bleu == ref_bleu
