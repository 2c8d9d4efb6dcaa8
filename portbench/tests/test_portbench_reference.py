"""The frozen reference against the port's plain path (the CPU versions of
its kernels) at a tiny size: in float32 the two are the same function, so
their logits agree to rounding; the fp8 control does not."""

import json

import pytest
import torch

from mmqg_tpu_torch import decode as DEC
from mmqg_tpu_torch.models import qg_model
from mmqg_tpu_torch.pipeline import QGPipeline
from portbench import gen, weights
from portbench.reference import inputs as RI
from portbench.reference.model import Reference
from portbench.tests.conftest import TINY, TINY_MIX, PKG

torch.set_num_threads(2)


def _setup(name, seed):
    cfg = json.loads((PKG / "configs" / f"{name}.json").read_text())
    cfg.update(TINY)
    mix = json.loads((PKG / "mixes" / "bulk_b32.json").read_text())
    mix.update(TINY_MIX["bulk_b32"])
    params, state = weights.make(cfg, seed, "cpu")
    vocab, i2w = gen.vocab(cfg["n_vocab"])
    mc = qg_model.ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                                 for k, v in cfg.items()
                                 if k in qg_model.ModelConfig._fields})
    pipe = QGPipeline(None, mc, params, state, vocab, i2w, device="cpu",
                      dtype=torch.float32)
    batch = gen.bulk_pool(cfg, mix, seed, "cpu")[0]
    return cfg, params, state, vocab, pipe, batch


def _port_logits(pipe, batch):
    host = pipe._pack(*batch)
    dev = pipe._to_device(host)
    mem, st = DEC.encode(pipe.model, pipe.mc, dev, dtype=torch.float32)
    toks, logits = DEC.decode_from_memories(
        pipe.model, mem, st, max_len=pipe.mc.target_steps - 1,
        dtype=torch.float32, return_logits=True)
    return toks.numpy(), logits


@pytest.mark.parametrize("name", ["trimodal_attn", "text_video_nonattn"])
def test_reference_matches_port_f32(name):
    cfg, params, state, vocab, pipe, batch = _setup(name, 7)
    toks, logits = _port_logits(pipe, batch)
    contexts, frames, audio = batch
    n = len(contexts)
    served = [list(t) for t in toks[:n]]
    ids = [RI.context_ids(c, vocab, cfg["context_max_length"])[0]
           for c in contexts]
    fr = [RI.frames_u8(f, cfg["av_max_length"]) for f in frames]
    ref = Reference(cfg, params, state, "cpu")
    zs = ref.logits(ids, fr, audio, served)
    for i, z in enumerate(zs):
        want = logits[i, :len(served[i])]
        scale = float(want.abs().max())
        assert float((z - want).abs().max()) <= 1e-4 * max(1.0, scale)


def test_control_departs_from_reference():
    cfg, params, state, vocab, pipe, batch = _setup("trimodal_attn", 11)
    toks, logits = _port_logits(pipe, batch)
    contexts, frames, audio = batch
    served = [list(t) for t in toks[:len(contexts)]]
    ids = [RI.context_ids(c, vocab, cfg["context_max_length"])[0]
           for c in contexts]
    fr = [RI.frames_u8(f, cfg["av_max_length"]) for f in frames]
    z32 = Reference(cfg, params, state, "cpu").logits(ids, fr, audio, served)
    z8 = Reference(cfg, params, state, "cpu", "fp8").logits(ids, fr, audio,
                                                             served)
    err = max(float((a - b).abs().max()) for a, b in zip(z32, z8))
    assert err > 1e-2


def _tiny_train(tiny_root, seed):
    """A Trainer on the tiny training cell, its step made in float32."""
    from mmqg_tpu_torch.train import make_train_step
    from portbench import run as R
    from portbench.traffic import train as T

    mix = json.loads((tiny_root / "mixes" / "train_b32.json").read_text())
    mix.update(batch=3, batches=3, words=[3, 20], question_words=[1, 4],
               frames=[2, 12], audio_s=[1, 2])
    (tiny_root / "mixes" / "train_b32.json").write_text(json.dumps(mix))
    run = R.Run("trimodal_attn.train", seed, 1.0, False, "cpu", tiny_root)
    trainer, ds, corpus = T.build(run, tiny_root)
    trainer.train_step = make_train_step(run.model_config(),
                                         trainer.optimizer,
                                         dtype=torch.float32)
    return run, mix, trainer, ds, corpus


def test_reference_training_follows_the_port_f32(tiny_root):
    """Three f32 steps of the port's Trainer (plain path) and of the
    reference agree: losses, first gradients and the change of every
    leaf."""
    from portbench.reference import train as RT
    from portbench.traffic import train as T

    run, mix, trainer, ds, corpus = _tiny_train(tiny_root, 21)
    follow = T.Follow(trainer, 3, ds)
    trainer.train_step = follow
    trainer.run_epoch(0)
    batches = [T._rows(run.cfg, run.vocab, corpus, r) for r in follow.rows]
    ref = RT.follow(run.cfg, run.params, run.state, batches, mix["lr"],
                    "cpu")
    got = T.compare([float(l) for l in follow.loss], follow.grad,
                    follow.change, ref, follow.grad_vectors)
    assert got["loss_gap"] < 1e-5
    assert got["grad_gap"] < 1e-3
    assert got["grad_diff_median"] < 1e-3
    # Adam divides each gradient element by its own root mean square, so
    # elements with gradients near eps carry f32 rounding into the change
    assert got["change_gap"] < 5e-3
