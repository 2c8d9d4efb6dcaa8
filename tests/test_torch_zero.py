"""ZeRO-1 and FSDP over the data axis (``mmqg_tpu_torch.parallel.zero``,
``mesh.zero1_shardings``/``fsdp_shardings``,
``make_train_step(zero1=, fsdp=)``, the Trainer's ``config.zero1`` and
``config.fsdp``, the train CLI's ``--zero1``/``--fsdp``) against the JAX
package's rule, the plain data-parallel step and one process's step.

The rule: the split dimension of every parameter and optimizer-state leaf
equals the "data" dimension of JAX's ``fsdp_shardings`` and
``zero1_shardings`` on a (2, 1) mesh, built in a child process with two
host devices (shapes only: nothing runs on it).

The steps: two gloo ranks on the CPU (real processes, one thread each),
the tiny text_video model in f32, two optimizer steps of 6 rows (3 a
rank) with each of three optimizers -- Adam with a clip that binds, AdamW
with the clip and ``text_non_trainable``, plain Adam -- taken plain
(all-reduce), ZeRO-1 and FSDP. After the two steps every leaf of the
gathered state (parameters, optimizer state, batchnorm statistics) is
within 1e-6 of the leaf's largest value of the plain step's (measured:
equal, bit for bit) and within 1e-4 of one process's two steps on the
whole rows: the plain data-parallel step itself is 1.2e-5 from those (the
conv biases ahead of batchnorm, whose gradients are f32 rounding noise,
summed in another order), the tolerance of the data-parallel step's
gradients in ``test_torch_multihost.py``. Plain Adam's sharded checkpoints
are the plain run's, byte for byte.
Between steps each rank holds the bytes the rule gives and no more.

A ZeRO-1 ``Trainer`` epoch over the two ranks has one process's epoch loss
within 1e-5 (the JAX package's own mesh test allows 2e-2,
``tests/parallel_cases.py:453,496``); resuming its checkpoint into a
ZeRO-1 and an FSDP Trainer gives back every leaf exactly. Two more ranks
train an epoch through the CLI with ``--fsdp`` and asynchronous
checkpoints.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mmqg_tpu_torch import checkpoint as ckpt

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
WORLD = 2
ROWS = 6
LEAF_RTOL = 1e-6
SINGLE_RTOL, SINGLE_LOSS_RTOL = 1e-4, 1e-5
EPOCH_LOSS_ATOL = 1e-5
CHILD_TIMEOUT = 240
MODES = ("plain", "zero1", "fsdp")
# grad_clip_norm 1e-3 sits far below the tiny model's gradient norm, so
# the clip scales every update
OPTIMIZERS = {
    "adam_clip": dict(optim="adam", lr=1e-3, grad_clip_norm=1e-3),
    "adamw_clip_freeze": dict(optim="adam", lr=1e-3, weight_decay=1e-2,
                              grad_clip_norm=1e-3, text_non_trainable=True),
    "adam": dict(optim="adam", lr=1e-3)}


def _opt_config(kw) -> SimpleNamespace:
    base = dict(lr=1e-3, optim="adam", grad_clip_norm=0.0, weight_decay=0.0,
                lr_schedule="constant", lr_warmup_steps=0, lr_decay_steps=0,
                lr_min_ratio=0.0, text_non_trainable=False)
    base.update(kw)
    return SimpleNamespace(**base)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"     # the suite runs several files at once
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    env.update(extra)
    return env


def _popen(args, **env):
    return subprocess.Popen(args, cwd=REPO, env=_env(**env),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _child_cmd(fn: str, *args) -> list:
    return [sys.executable, "-c", "import sys; from tests.test_torch_zero "
            f"import {fn}; {fn}(*sys.argv[1:])", *map(str, args)]


def _wait(procs):
    """(returncode, output) of each child; one that outlives the timeout
    is killed and reported."""
    outs = []
    try:
        for p in procs:
            try:
                out, _ = p.communicate(timeout=CHILD_TIMEOUT)
            except subprocess.TimeoutExpired:
                p.kill()
                out = (p.communicate()[0] or "") + "\n[child timed out]"
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


# ------------------------------------------------------------ the children

def _step_child(rank: str, coordinator: str, data_dir: str) -> None:
    """One rank: two steps of every optimizer in every mode; the gathered
    states, losses, held bytes and the checkpoint the save path writes,
    into ``<data_dir>/rank<r>.msgpack``."""
    import torch.distributed as dist

    from mmqg_tpu_torch.compat.from_jax import (params_from_numpy,
                                                train_state_to_numpy)
    from mmqg_tpu_torch.models import qg_model as TQ
    from mmqg_tpu_torch.optim import make_optimizer
    from mmqg_tpu_torch.parallel import multihost as MH
    from mmqg_tpu_torch.parallel import zero
    from mmqg_tpu_torch.parallel.mesh import row_block
    from mmqg_tpu_torch.train import TrainState, make_train_step, to_device

    torch.set_num_threads(1)
    rank, d = int(rank), Path(data_dir)
    MH.initialize_multihost(coordinator, WORLD, rank, device="cpu",
                            timeout_s=CHILD_TIMEOUT)
    group = dist.group.WORLD
    inp = ckpt.msgpack_restore((d / "inputs.msgpack").read_bytes())
    mc = TQ.ModelConfig(**json.loads((d / "mc.json").read_text()))
    lo, hi = row_block(rank, WORLD, ROWS)
    out = {}
    for name, kw in OPTIMIZERS.items():
        opt = make_optimizer(_opt_config(kw))
        for mode in MODES:
            model = params_from_numpy(inp["params"], inp["model_state"],
                                      "cpu", trainable=True)
            TQ.set_process_group(model, group)
            ts = TrainState(model, opt.init(TQ.param_tree(model)))
            step = make_train_step(mc, opt, dtype=torch.float32,
                                   process_group=group,
                                   zero1=mode == "zero1",
                                   fsdp=mode == "fsdp")
            losses, norms, held = [], [], []
            for batch in inp["batches"]:
                ts, m = step(ts, to_device({k: v[lo:hi] for k, v in
                                            batch.items()}, "cpu"), None)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
                held.append([v for _, v in sorted(
                    zero.held_bytes(ts).items())])
            host = (ts.shards.host_state(ts) if ts.shards is not None
                    else train_state_to_numpy(ts.model, ts.opt_state,
                                              ts.step))
            ckpt.save_checkpoint(d / "ckpt" / f"{name}-{mode}", "last",
                                 host if rank == 0 else None, group=group)
            out[f"{name}/{mode}"] = {
                "loss": np.asarray(losses), "grad_norm": np.asarray(norms),
                "held": np.asarray(held, np.int64), "state": host}
    (d / f"rank{rank}.msgpack").write_bytes(ckpt.msgpack_serialize(out))
    dist.destroy_process_group()


def _trainer_child(rank: str, coordinator: str, config_path: str) -> None:
    """One rank: a ZeRO-1 Trainer epoch, then a ZeRO-1 and an FSDP Trainer
    resumed from its ``last``; their gathered states on rank 0 against the
    file, into ``<output>/rank<r>.json``."""
    import torch.distributed as dist

    from mmqg_tpu_torch.config import Config
    from mmqg_tpu_torch.parallel import multihost as MH

    torch.set_num_threads(1)
    rank = int(rank)
    MH.initialize_multihost(coordinator, WORLD, rank, device="cpu",
                            timeout_s=CHILD_TIMEOUT)
    cfg = Config.load(config_path)
    trainer = _trainer(cfg, dist.group.WORLD)
    stats, _ = trainer.fit(1)
    out = {"loss": stats["train"]["loss"][0],
           "sharded": [trainer.zero1, trainer.fsdp]}
    saved = ckpt.load_checkpoint(cfg.checkpoint_dir, "last")
    for what in ("zero1", "fsdp"):
        again = _trainer(cfg.replace(**{what: True}), dist.group.WORLD)
        assert again.resume("last") and again.start_epoch == 1
        ts = again.train_state
        out[f"{what}_resumed_exact"] = _trees_equal(
            ts.shards.host_state(ts), saved)
        out[f"{what}_split_leaves"] = len(ts.shards.split)
    (cfg.output_path / f"rank{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()


def _trainer(cfg, group):
    from mmqg_tpu_torch.data.dataset import QGDataset
    from mmqg_tpu_torch.models import qg_model as TQ
    from mmqg_tpu_torch.train import Trainer

    train_ds = QGDataset(cfg, cfg.train_file)
    val_ds = QGDataset(cfg, cfg.val_file)
    mc = TQ.ModelConfig.from_config(cfg, n_vocab=len(train_ds.vocab),
                                    mode="text_video")
    emb = np.load(cfg.weights_matrix_file).astype(np.float32)
    return Trainer(cfg, mc, emb, train_ds, val_ds, device="cpu",
                   process_group=group, log_fn=lambda *a: None)


def _trees_equal(a, b) -> bool:
    if isinstance(a, dict):
        return set(a) == set(b) and all(_trees_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_trees_equal, a, b))
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def _jax_rule_child(spec_path: str, out_path: str) -> None:
    """JAX's zero1_shardings/fsdp_shardings on a (2, 1) mesh of two host
    devices, for the parameter shapes of ``spec_path``: each leaf's "data"
    dimension (or None) by its state-dict path."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from flax import serialization

    from mmqg_tpu import train as JT
    from mmqg_tpu.parallel.mesh import (fsdp_shardings, make_mesh,
                                        zero1_shardings)

    mesh = make_mesh((2, 1), devices=jax.devices()[:2])

    def shapes(node):
        if isinstance(node, dict) and "__shape__" in node:
            return jax.ShapeDtypeStruct(tuple(node["__shape__"]),
                                        np.float32)
        if isinstance(node, dict):
            return {k: shapes(v) for k, v in node.items()}
        return [shapes(v) for v in node]

    def data_dims(tree, prefix=""):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                out.update(data_dims(v, f"{prefix}{k}/"))
            return out
        spec = tuple(tree.spec)
        return {prefix.rstrip("/"): spec.index("data") if "data" in spec
                else None}

    out = {}
    for case in json.loads(Path(spec_path).read_text()):
        params = shapes(case["params"])
        opt_state = jax.eval_shape(
            JT.make_optimizer(_opt_config(case["optim"])).init, params)
        out[case["name"]] = {
            "params": data_dims(serialization.to_state_dict(
                fsdp_shardings(params, mesh))),
            "opt_state": data_dims(serialization.to_state_dict(
                zero1_shardings(opt_state, mesh)))}
    Path(out_path).write_text(json.dumps(out))


# ---------------------------------------------------------------- fixtures

def _tiny_text_video(tiny_config):
    """The port's ModelConfig of the tiny text_video model (no dropout),
    its parameters and batchnorm state (random statistics)."""
    from mmqg_tpu_torch.models import qg_model as TQ
    from tests.torch_port_fixtures import tiny_model

    mc, params, state = tiny_model(tiny_config, n_vocab=41, seed=6)
    mc = TQ.ModelConfig(**mc._replace(mode="text_video", dropout=0.0,
                                      text_dropout=0.0)._asdict())
    params.pop("audio_enc")
    params["decoder"]["attn"] = params["decoder"]["attn"]._asdict()
    return mc, params, state


def _batches(mc) -> list:
    from tests.torch_port_fixtures import tiny_batch

    out = []
    for seed in (11, 12):
        b = tiny_batch(mc, B=ROWS, seed=seed)
        rng = np.random.RandomState(seed)
        b["target_ids"] = rng.randint(3, mc.n_vocab, (ROWS, mc.target_steps)
                                      ).astype(np.int32)
        b["target_len"] = rng.randint(1, mc.target_steps + 1, ROWS
                                      ).astype(np.int32)
        b["valid"] = np.ones(ROWS, bool)
        out.append(b)
    return out


@pytest.fixture(scope="module")
def runs(tiny_config, tiny_corpus, tmp_path_factory):
    """Start the step ranks, the Trainer ranks and the CLI ranks together;
    meanwhile take one process's steps and epoch. Returns what they
    wrote."""
    from mmqg_tpu_torch.config import Config

    d = tmp_path_factory.mktemp("zero")
    mc, params, state = _tiny_text_video(tiny_config)
    batches = _batches(mc)
    (d / "mc.json").write_text(json.dumps(mc._asdict()))
    (d / "inputs.msgpack").write_bytes(ckpt.msgpack_serialize(
        {"params": params, "model_state": state, "batches": batches}))

    base = Config.load(tiny_config.save(d / "tiny.json")).replace(
        lr=1e-3, text_lstm_dropout=0.0, dec_lstm_dropout=0.0)
    trainer_cfg = base.replace(output_path=d / "trainer" / "results",
                               zero1=True)
    trainer_cfg.ensure_dirs()
    cli_cfg = base.replace(output_path=d / "cli" / "results",
                           checkpoint_async=True)
    cli_cfg.ensure_dirs()
    ports = [_free_port() for _ in range(3)]
    procs = [_popen(_child_cmd("_step_child", r, f"localhost:{ports[0]}", d))
             for r in range(WORLD)]
    procs += [_popen(_child_cmd("_trainer_child", r, f"localhost:{ports[1]}",
                                trainer_cfg.save()))
              for r in range(WORLD)]
    procs += [_popen([sys.executable, "-m", "mmqg_tpu_torch.train", "-c",
                      str(cli_cfg.save()), "--epochs", "1", "--device",
                      "cpu", "--mode", "text_video", "--multihost",
                      "--data-parallel", "--fsdp", "--coordinator",
                      f"localhost:{ports[2]}", "--num-processes",
                      str(WORLD), "--process-id", str(r)])
              for r in range(WORLD)]
    try:        # one process's reference, while the ranks run
        single = {name: _single_steps(mc, params, state, batches, kw)
                  for name, kw in OPTIMIZERS.items()}
        single_epoch = _trainer(base.replace(
            output_path=d / "single" / "results"), None).fit(1)[0]
    finally:
        results = _wait(procs)
    for code, out in results[:2 * WORLD]:
        assert code == 0, out
    ranks = [ckpt.msgpack_restore((d / f"rank{r}.msgpack").read_bytes())
             for r in range(WORLD)]
    trainer = [json.loads((trainer_cfg.output_path / f"rank{r}.json")
                          .read_text()) for r in range(WORLD)]
    return SimpleNamespace(
        dir=d, mc=mc, params=params, state=state, single=single,
        ranks=ranks, trainer=trainer,
        single_loss=single_epoch["train"]["loss"][0], cli=cli_cfg,
        cli_results=results[2 * WORLD:])


def _single_steps(mc, params, state, batches, kw):
    """One process's two steps on the whole rows: (losses, state)."""
    from mmqg_tpu_torch.compat.from_jax import (params_from_numpy,
                                                train_state_to_numpy)
    from mmqg_tpu_torch.models import qg_model as TQ
    from mmqg_tpu_torch.optim import make_optimizer
    from mmqg_tpu_torch.train import TrainState, make_train_step, to_device

    opt = make_optimizer(_opt_config(kw))
    model = params_from_numpy(params, state, "cpu", trainable=True)
    ts = TrainState(model, opt.init(TQ.param_tree(model)))
    step = make_train_step(mc, opt, dtype=torch.float32)
    losses = []
    for b in batches:
        ts, m = step(ts, to_device(b, "cpu"), None)
        losses.append(float(m["loss"]))
    return losses, train_state_to_numpy(ts.model, ts.opt_state, ts.step)


def _pairs(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            yield from _pairs(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _pairs(x, y, f"{path}/{i}")
    else:
        yield path, np.asarray(a), np.asarray(b)


def _worst(got, ref) -> tuple:
    """The leaf whose largest difference is the largest share of its own
    largest value: (share, path)."""
    worst = (0.0, "")
    n = 0
    for path, g, r in _pairs(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype, path
        n += 1
        scale = max(float(np.abs(r).max(initial=0.0)), 1e-30)
        share = float(np.abs(g.astype(np.float64) - r).max(initial=0.0)) \
            / scale
        worst = max(worst, (share, path))
    assert n > 30
    return worst


# ------------------------------------------------------------------- tests

@pytest.mark.parametrize("optimizer", list(OPTIMIZERS))
@pytest.mark.parametrize("mode", ["zero1", "fsdp"])
def test_sharded_steps_equal_the_plain_and_the_single_process_steps(
        runs, optimizer, mode):
    """Two sharded steps: every leaf of the gathered state within 1e-6 of
    its largest value of the plain data-parallel state, and within 1e-4 of
    one process's, where the plain state is no nearer; the losses
    likewise; both ranks gather the same state."""
    got = [r[f"{optimizer}/{mode}"] for r in runs.ranks]
    plain = runs.ranks[0][f"{optimizer}/plain"]
    single_losses, single_state = runs.single[optimizer]
    assert _trees_equal(got[0]["state"], got[1]["state"])
    share, path = _worst(got[0]["state"], plain["state"])
    assert share <= LEAF_RTOL, (path, share)
    np.testing.assert_allclose(got[0]["loss"], plain["loss"], rtol=LEAF_RTOL)
    share, path = _worst(got[0]["state"], single_state)
    assert share <= SINGLE_RTOL, (path, share)
    assert share <= _worst(plain["state"], single_state)[0] + LEAF_RTOL
    np.testing.assert_allclose(got[0]["loss"], single_losses,
                               rtol=SINGLE_LOSS_RTOL)
    np.testing.assert_allclose(got[0]["grad_norm"], plain["grad_norm"],
                               rtol=LEAF_RTOL)
    if "clip" in optimizer:       # the clip bound: it scaled the updates
        assert got[0]["grad_norm"].min() > OPTIMIZERS[optimizer][
            "grad_clip_norm"] * 100
    assert int(got[0]["state"]["step"]) == 2


@pytest.mark.parametrize("mode", ["zero1", "fsdp"])
def test_sharded_checkpoints_are_the_plain_ones_byte_for_byte(runs, mode):
    """Plain Adam (no clip: nothing reduces over the tree): the sharded
    state is the plain data-parallel state bit for bit, and the file the
    save path writes from it is the plain run's, byte for byte."""
    d = runs.dir / "ckpt"
    assert _trees_equal(runs.ranks[0][f"adam/{mode}"]["state"],
                        runs.ranks[0]["adam/plain"]["state"])
    sharded = (d / f"adam-{mode}" / "last.msgpack").read_bytes()
    assert sharded == (d / "adam-plain" / "last.msgpack").read_bytes()
    assert not (d / f"adam-{mode}" / "last.orbax").exists()


@pytest.mark.parametrize("optimizer", list(OPTIMIZERS))
def test_ranks_hold_the_slices_the_rule_gives(runs, optimizer):
    """Between steps each rank holds, of the optimizer state and of the
    parameters, the bytes of its share under the rule: the moments' split
    leaves 1/2, the whole leaves all (ZeRO-1 keeps the parameters whole,
    FSDP splits them too); the plain step holds everything."""
    from mmqg_tpu_torch.compat.from_jax import params_from_numpy
    from mmqg_tpu_torch.models import qg_model as TQ
    from mmqg_tpu_torch.optim import make_optimizer
    from mmqg_tpu_torch.parallel import zero
    from mmqg_tpu_torch.parallel.mesh import (fsdp_shardings,
                                              zero1_shardings)

    model = params_from_numpy(runs.params, runs.state, "cpu")
    params = TQ.param_tree(model)
    opt_state = make_optimizer(_opt_config(OPTIMIZERS[optimizer])).init(
        params)
    full = {"opt_state": zero.rule_bytes(opt_state, zero1_shardings(
        opt_state, 1), 1), "params": zero.rule_bytes(params, fsdp_shardings(
            params, 1), 1)}
    share = {"opt_state": zero.rule_bytes(opt_state, zero1_shardings(
        opt_state, WORLD), WORLD), "params": zero.rule_bytes(
            params, fsdp_shardings(params, WORLD), WORLD)}
    want = {"plain": full, "zero1": {"opt_state": share["opt_state"],
                                     "params": full["params"]},
            "fsdp": share}
    assert share["opt_state"] < 0.6 * full["opt_state"]
    for r in runs.ranks:
        for mode in MODES:
            held = r[f"{optimizer}/{mode}"]["held"]
            for after_step in held:
                assert list(after_step) == [want[mode]["opt_state"],
                                            want[mode]["params"]], mode


def test_zero1_trainer_epoch_and_sharded_resume(runs):
    """A ZeRO-1 Trainer epoch on two ranks: its loss within 1e-5 of one
    process's epoch; its checkpoint resumed by a ZeRO-1 and an FSDP
    Trainer gives back every leaf exactly, on both ranks."""
    for out in runs.trainer:
        assert out["sharded"] == [True, False]
        assert abs(out["loss"] - runs.single_loss) <= EPOCH_LOSS_ATOL
        for what in ("zero1", "fsdp"):
            assert out[f"{what}_resumed_exact"], what
            assert out[f"{what}_split_leaves"] > 10


def test_fsdp_cli_trains_on_two_gloo_ranks(runs):
    """``train --multihost --data-parallel --fsdp`` on two CPU processes
    with asynchronous checkpoints: both exit 0, rank 0 logs and writes
    ``last``, ``best`` and stats.json."""
    for code, out in runs.cli_results:
        assert code == 0, out
    log = runs.cli_results[0][1]
    assert "data-parallel over 2 processes" in log and "Done !" in log
    assert runs.cli_results[1][1].count("epoch 0") == 0
    for alias in ("last", "best"):
        assert ckpt.has_checkpoint(runs.cli.checkpoint_dir, alias)
    state = ckpt.load_checkpoint(runs.cli.checkpoint_dir, "last")
    assert int(state["step"]) > 0 and "audio_enc" not in state["params"]
    assert runs.cli.stats_json_path.exists()


def _shape_tree(tree):
    if isinstance(tree, dict):
        return {k: _shape_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shape_tree(v) for v in tree]
    return {"__shape__": list(np.shape(tree))}


def test_split_dimensions_equal_jax_rule(tiny_config, tmp_path):
    """For every parameter and optimizer-state leaf -- the tri-modal tiny
    model with the conv-LSTM and with R(2+1)D-18 (5-d convs), three
    optimizers -- the port's split dimension at dp=2 is the dimension
    JAX's fsdp_shardings / zero1_shardings put "data" on in a (2, 1) mesh
    (the TP spec's "model" dimensions skipped, as there)."""
    from mmqg_tpu_torch.models import qg_model as TQ
    from mmqg_tpu_torch.optim import make_optimizer, tree_map
    from mmqg_tpu_torch.parallel.mesh import (fsdp_shardings,
                                              zero1_shardings)

    cases, port = [], {}
    for name, venc, optim in (
            ("conv_lstm/adamw_clip_freeze", "conv_lstm",
             OPTIMIZERS["adamw_clip_freeze"]),
            ("resnet/adam", "resnet", OPTIMIZERS["adam"]),
            ("conv_lstm/adam_clip", "conv_lstm", OPTIMIZERS["adam_clip"])):
        mc = TQ.ModelConfig.from_config(
            tiny_config.replace(video_encoder=venc), n_vocab=41,
            mode="trimodal")
        params, _ = TQ.init_params(mc, 0)
        meta = tree_map(lambda a: torch.empty(a.shape, device="meta"),
                        params)
        opt_state = make_optimizer(_opt_config(optim)).init(meta)
        cases.append({"name": name, "params": _shape_tree(params),
                      "optim": optim})
        port[name] = {"params": _flat_dims(fsdp_shardings(meta, WORLD)),
                      "opt_state": _flat_dims(zero1_shardings(opt_state,
                                                              WORLD))}
    spec, out = tmp_path / "spec.json", tmp_path / "jax.json"
    spec.write_text(json.dumps(cases))
    proc = subprocess.run(
        _child_cmd("_jax_rule_child", spec, out), cwd=REPO,
        env=_env(JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=2"),
        capture_output=True, text=True, timeout=CHILD_TIMEOUT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    ref = json.loads(out.read_text())
    for name, trees in port.items():
        for what in ("params", "opt_state"):
            want = {k: v for k, v in ref[name][what].items()}
            got = trees[what]
            assert set(got) == set(want), (name, what)
            assert got == want, (name, what, {
                k: (got[k], want[k]) for k in got if got[k] != want[k]})
            split = sum(v is not None for v in got.values())
            assert 0 < split < len(got), (name, what)
    # the TP spec's model dimension is skipped: the attention's location
    # heads split their second dimension, the conv kernels no output
    # channels
    dims = port["conv_lstm/adam_clip"]["params"]
    assert dims["decoder/attn/w_text"] == 1
    assert dims["video_enc/convs/0/w"] is None


def _flat_dims(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_dims(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat_dims(v, f"{prefix}{i}/"))
        return out
    return {prefix.rstrip("/"): tree}
