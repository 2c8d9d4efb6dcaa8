"""The port's training driver vs the JAX package, on the tiny corpus:
train-step trajectories (plain and gradient-accumulated), msgpack
checkpoints in both directions, ``Trainer.resume``, the CLI, and that
``mmqg_tpu_torch.train`` imports no JAX.

f32, dropout 0, the same initial train state on both sides (the JAX
package's train-state pytree, carried over by ``params_from_numpy`` and
``load_train_state``), and seeded noise added to the corpus's audio so
that the audio attention gets a gradient. Per-step losses within 1e-4
relative. Adam (the default, 3 steps): the moments, which are linear and
quadratic in the gradients, within 1e-4 relative per leaf (a leaf whose
gradient is f32 noise is held to that noise level instead); the
parameters within atol 5e-4, because Adam moves an element whose gradient
is near zero by about lr (1e-3) on that gradient's sign, which f32 noise
decides (measured 1.3e-4 after two steps). SGD (accumulated step): the
parameters within atol 1e-5, as the update is linear in the gradient."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from mmqg_tpu import checkpoint as JC
from mmqg_tpu import train as JT
from mmqg_tpu.data.dataset import QGDataset
from mmqg_tpu.models import qg_model as JQ
from mmqg_tpu_torch import checkpoint as ckpt
from mmqg_tpu_torch.compat.from_jax import (load_train_state,
                                            params_from_numpy,
                                            train_state_to_numpy)
from mmqg_tpu_torch.models import qg_model as TQ
from mmqg_tpu_torch.optim import make_optimizer, tree_leaves
from mmqg_tpu_torch.train import (TrainState, Trainer, batch_arrays, main,
                                  make_train_step, to_device)
from tests.torch_port_fixtures import drop_checkpoints, tiny_model

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """Each test's checkpoints are read by its end; pytest keeps its tmp
    dir until the suite ends (``drop_checkpoints``)."""
    yield
    drop_checkpoints(tmp_path)


REPO = Path(__file__).resolve().parent.parent
LOSS_RTOL, MOMENT_RTOL = 1e-4, 1e-4
ADAM_PARAM_ATOL, SGD_PARAM_ATOL = 5e-4, 1e-5
# a leaf whose gradient is f32 noise on both sides (~1e-7: the loss test's
# floor) has moments at that noise: mu ~ g, nu ~ 1e-3 g^2
MOMENT_NOISE = {"mu": 1e-7, "nu": 1e-14}
N_STEPS = 3
_JAX_STEPS = {}


def _host(tree):
    return jax.tree.map(lambda x: np.asarray(x) if hasattr(x, "ndim") else x,
                        tree)


@pytest.fixture(scope="module")
def setup(tiny_config, tiny_corpus):
    cfg = tiny_config.replace(lr=1e-3)
    ds = QGDataset(cfg, cfg.train_file)
    mc, params, state = tiny_model(cfg, n_vocab=len(ds.vocab), seed=6)
    mc = mc._replace(dropout=0.0, text_dropout=0.0)
    ts0 = _host({"params": params, "model_state": state,
                 "opt_state": JT.make_optimizer(cfg).init(params),
                 "step": np.zeros((), np.int32)})
    rng = np.random.RandomState(5)
    batches = []
    for b in list(ds.batches(4))[:N_STEPS]:
        b = batch_arrays(b)
        b["audio_pcm"] = np.clip(b["audio_pcm"] + rng.randn(
            *b["audio_pcm"].shape) * 3000, -32768, 32767).astype(np.int16)
        batches.append(b)
    return cfg, mc, ts0, batches


def _port_state(cfg, ts):
    """The port's TrainState from a JAX train state (numpy leaves)."""
    model = params_from_numpy(ts["params"], ts["model_state"],
                              trainable=True)
    opt = make_optimizer(cfg)
    state = TrainState(model, opt.init(TQ.param_tree(model)))
    sd = serialization.to_state_dict(ts)
    state.opt_state, state.step = load_train_state(
        model, ckpt.msgpack_restore(ckpt.msgpack_serialize(sd)),
        state.opt_state)
    return state, opt


def _jax_run(mc, cfg, ts, batches, accum=1):
    """JAX's train states after each step, and the per-step losses."""
    key = (cfg.optim, accum)
    if key not in _JAX_STEPS:   # one compile per optimizer and accum
        _JAX_STEPS[key] = JT.make_train_step(
            mc, JT.make_optimizer(cfg), dtype=jnp.float32, accum_steps=accum,
            donate=False)
    state = jax.tree.map(jnp.asarray, ts)
    states, losses = [], []
    for b in batches:
        state, m = _JAX_STEPS[key](
            state, {k: jnp.asarray(v) for k, v in b.items()},
            jax.random.PRNGKey(1))
        states.append(_host(state))
        losses.append(float(m["loss"]))
    return states, losses


def _port_run(mc, cfg, ts, batches, accum=1):
    state, opt = _port_state(cfg, ts)
    step = make_train_step(TQ.ModelConfig(**mc._asdict()), opt,
                           dtype=torch.float32, accum_steps=accum)
    losses, norms = [], []
    for b in batches:
        state, m = step(state, to_device(b, "cpu"), None)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return state, losses, norms


def _leaves(state_tree):
    """Numpy leaves of a train-state tree in the port's reader layout."""
    return ckpt.msgpack_restore(ckpt.msgpack_serialize(
        serialization.to_state_dict(state_tree)))


def _assert_state_close(port_state, j_state, param_atol, moment_rtol=None):
    mine = _leaves(train_state_to_numpy(port_state.model,
                                        port_state.opt_state,
                                        port_state.step))
    ref = _leaves(j_state)
    got, want = tree_leaves(mine["params"]), tree_leaves(ref["params"])
    assert len(got) == len(want)
    worst = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
    assert worst <= param_atol
    if moment_rtol is not None:   # Adam's mu and nu, per leaf
        adam = mine["opt_state"][0], ref["opt_state"][0]
        for k, floor in MOMENT_NOISE.items():
            for a, b in zip(tree_leaves(adam[0][k]), tree_leaves(adam[1][k])):
                err = float(np.abs(a - b).max())
                assert err <= max(moment_rtol * float(np.abs(b).max()),
                                  floor), k


@pytest.fixture(scope="module")
def trajectories(setup):
    cfg, mc, ts0, batches = setup
    return _jax_run(mc, cfg, ts0, batches), _port_run(mc, cfg, ts0, batches)


def test_three_steps_match_jax(trajectories):
    (j_states, j_losses), (p_state, p_losses, norms) = trajectories
    np.testing.assert_allclose(p_losses, j_losses, rtol=LOSS_RTOL)
    assert p_state.step == int(j_states[-1]["step"]) == N_STEPS
    assert all(np.isfinite(norms)) and min(norms) > 0
    _assert_state_close(p_state, j_states[-1], ADAM_PARAM_ATOL, MOMENT_RTOL)


def test_accumulated_step_matches_jax(setup):
    """Two microbatches, valid-weighted, one SGD update: the first sample
    is padding, so the microbatches weigh 1/3 and 2/3."""
    cfg, mc, ts0, batches = setup
    cfg = cfg.replace(grad_accum_steps=2, optim="sgd", lr=0.1)
    ts0 = dict(ts0, opt_state=_host(JT.make_optimizer(cfg).init(
        ts0["params"])))
    batch = dict(batches[0], valid=batches[0]["valid"].copy())
    batch["valid"][0] = False
    j_states, j_losses = _jax_run(mc, cfg, ts0, [batch], accum=2)
    p_state, p_losses, _ = _port_run(mc, cfg, ts0, [batch], accum=2)
    np.testing.assert_allclose(p_losses, j_losses, rtol=LOSS_RTOL)
    _assert_state_close(p_state, j_states[-1], SGD_PARAM_ATOL)


def test_port_checkpoint_is_byte_identical_and_jax_restores_it(setup,
                                                               tmp_path):
    cfg, mc, ts0, _ = setup
    state, _ = _port_state(cfg, ts0)
    port_ts = train_state_to_numpy(state.model, state.opt_state, state.step)
    ckpt.save_checkpoint(tmp_path, "last", port_ts,
                         metadata={"epoch": 0, "best_val": 1.5})
    JC.save_checkpoint(tmp_path / "jax", "last", ts0)
    assert ((tmp_path / "last.msgpack").read_bytes()
            == (tmp_path / "jax" / "last.msgpack").read_bytes())
    restored, meta = JC.load_checkpoint(tmp_path, "last", ts0)
    assert meta == {"epoch": 0, "best_val": 1.5}
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(ts0)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)
    ckpt.copy_checkpoint(tmp_path, "last", "best")
    assert ckpt.has_checkpoint(tmp_path, "best")
    assert ckpt.load_metadata(tmp_path, "best") == meta
    # the orbax backend and an asynchronous copy (ported since): JAX
    # restores the port's orbax save, the copy holds the msgpack bytes
    ckpt.save_checkpoint(tmp_path, "x", port_ts, backend="orbax")
    restored, _ = JC.load_checkpoint(tmp_path, "x", ts0)
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(ts0)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)
    ckpt.copy_checkpoint(tmp_path, "last", "y", async_copy=True)
    ckpt.wait_for_pending()
    assert ((tmp_path / "y.msgpack").read_bytes()
            == (tmp_path / "last.msgpack").read_bytes())
    shutil.rmtree(tmp_path / "x.orbax")     # ~0.5 GB the suite need not keep
    (tmp_path / "y.msgpack").unlink()


def test_resume_from_a_jax_checkpoint_takes_the_jax_step(setup,
                                                        trajectories,
                                                        tmp_path):
    """JAX's state after its first step, saved by the JAX package; the
    port loads that file and takes the second step: JAX's second loss and
    state."""
    cfg, mc, ts0, batches = setup
    (j_states, j_losses), _ = trajectories
    JC.save_checkpoint(tmp_path, "last", j_states[0])
    state, opt = _port_state(cfg, ts0)
    state.opt_state, state.step = load_train_state(
        state.model, ckpt.load_checkpoint(tmp_path, "last"), state.opt_state)
    assert state.step == 1
    step = make_train_step(TQ.ModelConfig(**mc._asdict()), opt,
                           dtype=torch.float32)
    state, m = step(state, to_device(batches[1], "cpu"), None)
    np.testing.assert_allclose(float(m["loss"]), j_losses[1], rtol=LOSS_RTOL)
    _assert_state_close(state, j_states[1], ADAM_PARAM_ATOL, MOMENT_RTOL)
    wrong = make_optimizer(cfg.replace(optim="sgd"))
    with pytest.raises(ValueError, match="opt_state does not match"):
        load_train_state(state.model, ckpt.load_checkpoint(tmp_path, "last"),
                         wrong.init(TQ.param_tree(state.model)))


def _config_file(tiny_config, tmp_path):
    cfg = tiny_config.replace(output_path=tmp_path / "results", lr=5e-3)
    path = tmp_path / "config.json"
    cfg.save(path)
    return cfg, path


def test_trainer_resume_restores_epoch_best_and_history(tiny_config,
                                                        tiny_corpus,
                                                        tmp_path):
    cfg, _ = _config_file(tiny_config, tmp_path)
    cfg.ensure_dirs()
    ds = QGDataset(cfg, cfg.train_file)
    val = QGDataset(cfg, cfg.val_file)
    emb = np.load(cfg.weights_matrix_file).astype(np.float32)
    mc = TQ.ModelConfig.from_config(cfg, n_vocab=len(ds.vocab))
    tr = Trainer(cfg, mc, emb, ds, val, device="cpu",
                 log_fn=lambda *a: None)
    stats, best = tr.fit(epochs=2)
    assert len(stats["train"]["loss"]) == 2 and best >= 0
    fresh = Trainer(cfg, mc, emb, ds, val, device="cpu",
                    log_fn=lambda *a: None)
    assert fresh.resume("last")
    assert fresh.start_epoch == 2
    assert fresh.best_val == tr.best_val and fresh.best_epoch == tr.best_epoch
    assert fresh.epoch_stats == json.loads(cfg.stats_json_path.read_text())
    assert fresh.train_state.step == tr.train_state.step
    for a, b in zip(tree_leaves(TQ.param_tree(fresh.train_state.model)),
                    tree_leaves(TQ.param_tree(tr.train_state.model))):
        assert torch.equal(a, b)
    assert not fresh.resume("nothing-here")


def test_cli_trains_on_cpu_and_writes_stats_checkpoints_config(
        tiny_config, tiny_corpus, tmp_path):
    cfg, path = _config_file(tiny_config, tmp_path)
    proc = subprocess.run(
        [sys.executable, "-m", "mmqg_tpu_torch.train", "-c", str(path),
         "--epochs", "2", "--device", "cpu"], cwd=REPO, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Done !" in proc.stdout
    stats = json.loads(cfg.stats_json_path.read_text())
    assert len(stats["train"]["loss"]) == 2
    assert np.isfinite(stats["val"]["loss"]).all()
    assert (cfg.checkpoint_dir / "last.msgpack").exists()
    assert (cfg.checkpoint_dir / "best.msgpack").exists()
    assert (cfg.output_path / "config.json").exists()


def test_cli_refuses_unported_modes_and_a_missing_card(tiny_config,
                                                       tiny_corpus, tmp_path):
    """Every mode and decoder trains now: --mode text_video and --decoder
    non_attn each run an epoch and write a checkpoint that the JAX package
    restores into its own train state of that configuration; an unknown
    mode or decoder is refused as by the JAX CLI; without a card the
    default device raises."""
    cfg, path = _config_file(tiny_config, tmp_path)
    ds = QGDataset(cfg, cfg.train_file, load_media=False)
    for mode, dec in (("text_video", "attn"), ("trimodal", "non_attn")):
        main(["-c", str(path), "--mode", mode, "--decoder", dec,
              "--epochs", "1", "--device", "cpu"])
        jmc = JQ.ModelConfig.from_config(cfg, n_vocab=len(ds.vocab),
                                         mode=mode, dec=dec)
        params, state = jax.eval_shape(lambda: JQ.init(
            jax.random.PRNGKey(0), jmc, np.zeros(
                (len(ds.vocab), cfg.glove_emb_dim), np.float32)))
        target = {"params": params, "model_state": state,
                  "opt_state": JT.make_optimizer(cfg).init(params),
                  "step": jnp.zeros((), jnp.int32)}
        restored, meta = JC.load_checkpoint(cfg.checkpoint_dir, "last",
                                            target)
        assert meta["mode"] == mode and int(restored["step"]) > 0
        assert (jax.tree.structure(restored["params"])
                == jax.tree.structure(params))
        assert all(np.isfinite(np.asarray(x)).all()
                   for x in jax.tree.leaves(restored["params"]))
    for bad in (["--mode", "audio"], ["--decoder", "pointer"],
                ["--video-encoder", "i3d"]):
        with pytest.raises(SystemExit):
            main(["-c", str(path), "--device", "cpu"] + bad)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            main(["-c", str(path)])


def test_train_module_imports_no_jax():
    code = ("import sys, mmqg_tpu_torch.train; "
            "print(any(m.split('.')[0] in ('jax', 'mmqg_tpu') "
            "for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
