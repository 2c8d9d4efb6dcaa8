"""Multi-process data parallelism of the PyTorch port
(``mmqg_tpu_torch.parallel.multihost``, ``make_train_step(process_group=)``,
the train CLI's ``--multihost --data-parallel``) against the JAX package,
with two real processes joined by gloo on the CPU.

One module-scoped run starts four children at once: two run the
collectives and one data-parallel train step (``_child``), two train an
epoch through the CLI with ``--streaming``. The JAX reference runs here,
single-device, on the same batch padded to the data axis: under a mesh
JAX computes one program over that padded batch (GSPMD), whose padded row
has valid False and one zero frame -- a frame the video batchnorm's
statistics count, there as here.

The step: batch 5, padded to 6, rows 0-2 on rank 0 and 3-5 on rank 1,
with 8 valid frames on rank 0 and 4 on rank 1, so the batchnorm
statistics differ per rank; conv-LSTM tri-modal model, f32, dropout 0,
Adam. The objective within 1e-5 (relative), every gradient leaf within
1e-4 of the leaf's largest reference gradient, the parameters after the
step within 1e-5 (but where Adam's eps amplifies gradient noise, see the
test), the batchnorm running statistics within 1e-5, and the two ranks'
parameters and statistics identical. The JAX reference takes its video
batchnorm statistics in f64 (``jax_video_stats_f64``): the JAX package's
f32 statistics can sit 2.6e-3 of a gradient's scale from the exact ones
(``test_torch_train_loss.py``), the port's within 4.5e-6.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mmqg_tpu_torch import checkpoint as ckpt
from mmqg_tpu_torch.parallel.mesh import pad_batch, row_block

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
LOSS_RTOL, GRAD_RTOL, PARAM_ATOL, STATS_ATOL = 1e-5, 1e-4, 1e-5, 1e-5
# Adam's normalised step amplifies f32 noise where |g| ~ its eps
ADAM_NOISE_G, ADAM_NOISE_ATOL = 1e-6, 5e-4
WORLD = 2
ROWS = 5
FRAMES_LEN = [3, 2, 3, 1, 3]   # rank 0: 8 frames, rank 1: 3 + the pad's 1
CHILD_TIMEOUT = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child(rank: str, coordinator: str, data_dir: str) -> None:
    """One rank: the collectives' values and one data-parallel step,
    written to ``<data_dir>/rank<r>.msgpack``."""
    import torch.distributed as dist

    from mmqg_tpu_torch.compat.from_jax import (params_from_numpy,
                                                tree_to_numpy)
    from mmqg_tpu_torch.config import Config
    from mmqg_tpu_torch.models import qg_model as TQ
    from mmqg_tpu_torch.optim import Transform, make_optimizer, tree_leaves
    from mmqg_tpu_torch.parallel import multihost as MH
    from mmqg_tpu_torch.train import TrainState, make_train_step, to_device

    torch.set_num_threads(1)
    rank, d = int(rank), Path(data_dir)
    MH.initialize_multihost(coordinator, WORLD, rank, device="cpu",
                            timeout_s=CHILD_TIMEOUT)
    inp = ckpt.msgpack_restore((d / "inputs.msgpack").read_bytes())
    cfg = Config.load(d / "config.json")
    mc = TQ.ModelConfig(**json.loads((d / "mc.json").read_text()))
    out = {"rank": np.int32(rank), "world": np.int32(MH.world()[1]),
           "max": np.int64(MH.global_max_int(10 + 7 * rank)),
           "local_range": np.asarray(MH.local_row_range(6), np.int64),
           "loader_rows": np.asarray(MH.loader_local_rows(ROWS), np.int64),
           "to_host": MH.to_host(torch.arange(6).reshape(3, 2) + 100 * rank,
                                 rows=5)}

    model = params_from_numpy(inp["params"], inp["model_state"], "cpu",
                              trainable=True)
    base = make_optimizer(cfg)
    grads = []

    def update(g, s, p):
        grads.append(tree_to_numpy(g))
        return base.update(g, s, p)
    opt = Transform(base.init, update)
    ts = TrainState(model, opt.init(TQ.param_tree(model)))
    TQ.set_process_group(model, dist.group.WORLD)
    step = make_train_step(mc, opt, dtype=torch.float32,
                           process_group=dist.group.WORLD)
    padded = pad_batch(inp["batch"], WORLD)
    lo, hi = row_block(rank, WORLD, len(padded["valid"]))
    ts, m = step(ts, to_device({k: v[lo:hi] for k, v in padded.items()},
                               "cpu"), None)
    out.update(objective=m["objective"].numpy(), loss=m["loss"].numpy(),
               grads=grads[0], params=tree_to_numpy(TQ.param_tree(model)),
               state=tree_to_numpy(TQ.model_state(model)))
    out["differ"] = np.float64(MH.replicas_differ(
        tree_leaves(TQ.param_tree(model))
        + tree_leaves(TQ.model_state(model))))
    out["bn_all"] = _bn_all(dist.group.WORLD, slice(3 * rank, 3 * rank + 3))
    # gradient accumulation on the data axis, mode text (no batchnorm):
    # 3 microbatches of one row a rank against one step; the worst leaf's
    # |difference| over its largest gradient (the trees are ~94 MB each)
    text_mc = mc._replace(mode="text")
    text_grads = []
    for accum in (1, 3):
        grads.clear()
        tmodel = params_from_numpy(inp["params"], inp["model_state"], "cpu",
                                   trainable=True)
        tstep = make_train_step(text_mc, opt, dtype=torch.float32,
                                accum_steps=accum,
                                process_group=dist.group.WORLD)
        tstep(TrainState(tmodel, opt.init(TQ.param_tree(tmodel))),
              to_device({k: v[lo:hi] for k, v in padded.items()}, "cpu"),
              None)
        text_grads.append(tree_leaves(grads[0]))
    out["text_accum_worst"] = np.float64(max(
        float(np.abs(a - w).max()) / max(float(np.abs(w).max()), 1e-30)
        for w, a in zip(*text_grads) if np.abs(w).max() > 0))
    out["text_accum_leaves"] = np.int64(sum(
        np.abs(w).max() > 0 for w in text_grads[0]))
    (d / f"rank{rank}.msgpack").write_bytes(ckpt.msgpack_serialize(out))
    dist.destroy_process_group()


def _bn_all(group, rows: slice) -> dict:
    """R(2+1)D's train batchnorm over every position, with a ReLU
    (``BatchNorm.train_forward_all``), on ``rows`` of a fixed (6, 3, 4, 5)
    input: the output, its input and scale gradients for a fixed
    cotangent, and the new running statistics."""
    from mmqg_tpu_torch.models import layers as L

    rng = np.random.RandomState(0)
    x, gy = (torch.tensor(rng.randn(6, 3, 4, 5), dtype=torch.float32)
             for _ in range(2))
    bn = L.BatchNorm(*(torch.tensor(rng.rand(5) + 0.5, dtype=torch.float32)
                       for _ in range(4)))
    bn.scale.requires_grad_(True)
    bn.process_group = group
    xr = x[rows].clone().requires_grad_(True)
    y, st = bn.train_forward_all(xr, relu=True)
    (y * gy[rows]).sum().backward()
    return {"y": y.detach().numpy(), "gx": xr.grad.numpy(),
            "gscale": bn.scale.grad.numpy(), "mean": st["mean"].numpy(),
            "var": st["var"].numpy()}


def _env() -> dict:
    env = dict(os.environ)
    # one thread a child: the suite runs several test files at once
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


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


@pytest.fixture(scope="module")
def runs(tiny_config, tiny_corpus, tmp_path_factory):
    """Start the step children and the CLI children together; return the
    inputs, the step ranks' outputs and the CLI run's config and
    outputs."""
    from tests.torch_port_fixtures import tiny_batch, tiny_model
    from mmqg_tpu_torch.data.dataset import QGDataset

    d = tmp_path_factory.mktemp("multihost")
    cfg = tiny_config.replace(lr=1e-3)
    cfg.save(d / "config.json")
    ds = QGDataset(cfg, cfg.train_file)
    mc, params, state = tiny_model(cfg, n_vocab=len(ds.vocab), seed=6)
    mc = mc._replace(dropout=0.0, text_dropout=0.0)
    # He-scaled VGGish convs, so that audio examples embed apart and the
    # audio attention has gradients to compare (chip_smoke.he_vggish)
    params["audio_enc"]["convs"] = [
        {"w": (c["w"] * np.sqrt(6.0)).astype(np.float32), "b": c["b"]}
        for c in params["audio_enc"]["convs"]]
    (d / "mc.json").write_text(json.dumps(mc._asdict()))
    batch = tiny_batch(mc, B=ROWS, seed=11)
    batch["frames_len"] = np.asarray(FRAMES_LEN, np.int32)
    batch["target_ids"] = np.random.RandomState(3).randint(
        3, mc.n_vocab, (ROWS, mc.target_steps)).astype(np.int32)
    batch["target_len"] = np.asarray([4, 7, 2, 5, 6], np.int32)
    batch["valid"] = np.ones(ROWS, bool)
    p = dict(params, decoder=dict(params["decoder"],
                                  attn=params["decoder"]["attn"]._asdict()))
    (d / "inputs.msgpack").write_bytes(ckpt.msgpack_serialize(
        {"params": p, "model_state": state, "batch": batch}))

    cli = cfg.replace(output_path=d / "cli" / "results")
    cli.ensure_dirs()
    cli_path = cli.save(d / "cli_config.json")
    step_port, cli_port = _free_port(), _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import sys; from tests.test_torch_multihost "
         "import _child; _child(*sys.argv[1:])", str(r),
         f"localhost:{step_port}", str(d)],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    procs += [subprocess.Popen(
        [sys.executable, "-m", "mmqg_tpu_torch.train", "-c", str(cli_path),
         "--epochs", "1", "--device", "cpu", "--streaming", "--multihost",
         "--mode", "text_video",      # no audio tower: small checkpoints
         "--data-parallel", "--coordinator", f"localhost:{cli_port}",
         "--num-processes", str(WORLD), "--process-id", str(r)],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    try:
        ref = _jax_step(mc, params, state, batch, cfg)  # while they run
    finally:
        results = _wait(procs)
    for code, out in results[:WORLD]:
        assert code == 0, out
    ranks = [ckpt.msgpack_restore((d / f"rank{r}.msgpack").read_bytes())
             for r in range(WORLD)]
    # ~470 MB of trees (the VGGish fc layers): read, so not kept on disk
    for f in [d / "inputs.msgpack"] + [d / f"rank{r}.msgpack"
                                       for r in range(WORLD)]:
        f.unlink()
    return ref, ranks, (cli, results[WORLD:])


def _jax_step(mc, params, state, batch, cfg):
    """JAX's single-device step on the padded batch: objective, gradients,
    parameters after Adam, new batchnorm state (video statistics in f64)."""
    import jax
    import jax.numpy as jnp

    from mmqg_tpu import train as JT
    from mmqg_tpu.models import qg_model as JQ
    from tests.torch_port_fixtures import jax_video_stats_f64

    jb = {k: jnp.asarray(v) for k, v in pad_batch(batch, WORLD).items()}
    with jax_video_stats_f64():
        def f(p):
            return JQ.loss_fn(p, state, mc, jb, train=True,
                              dtype=jnp.float32)
        (obj, aux), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
            jax.tree.map(jnp.asarray, params))
    opt = JT.make_optimizer(cfg)

    @jax.jit
    def adam_step(g, p):    # one program: eager optax compiles each op
        updates, _ = opt.update(g, opt.init(p), p)
        return jax.tree.map(lambda a, u: a + u, p, updates)
    new = adam_step(grads, jax.tree.map(jnp.asarray, params))

    def host(tree):
        tree = jax.tree.map(np.asarray, tree)
        tree["decoder"]["attn"] = tree["decoder"]["attn"]._asdict()
        return tree
    return (float(obj), host(grads), host(new),
            jax.tree.map(np.asarray, aux["state"]))


def _pairs(a, b, path=""):
    if isinstance(a, dict):
        for k in a:
            yield from _pairs(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _pairs(x, y, f"{path}/{i}")
    else:
        yield path, np.asarray(a, np.float64), np.asarray(b, np.float64)


def test_collectives_match_the_jax_functions(runs):
    """global_max_int, local_row_range, loader_local_rows and to_host on
    two ranks give what the JAX functions give with one device a process:
    the max over the processes, each process's block of the padded batch
    (JAX's device order is process-major), clipped to the real rows, and
    the blocks gathered in rank order."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec
    from mmqg_tpu.parallel import make_mesh as jax_mesh
    from mmqg_tpu.parallel.multihost import global_max_int

    _, ranks, _ = runs
    mesh = jax_mesh((WORLD, 1), devices=jax.devices()[:WORLD])

    def block(r, rows):
        s = NamedSharding(mesh, PartitionSpec("data")).devices_indices_map(
            (rows,))[mesh.devices[r, 0]][0]
        return [s.start or 0, rows if s.stop is None else s.stop]
    for r, out in enumerate(ranks):
        assert int(out["world"]) == WORLD and int(out["rank"]) == r
        assert int(out["max"]) == max(10 + 7 * q for q in range(WORLD))
        assert list(out["local_range"]) == block(r, 6)
        assert list(out["loader_rows"]) == [min(x, ROWS)
                                            for x in block(r, 6)]
        np.testing.assert_array_equal(
            out["to_host"], np.concatenate(
                [np.arange(6).reshape(3, 2) + 100 * q
                 for q in range(WORLD)])[:5])
    # one process: the identity, as JAX's
    assert global_max_int(9) == 9


def test_dp_step_objective_matches_jax(runs):
    jax_step, ranks, _ = runs
    for out in ranks:
        np.testing.assert_allclose(float(out["objective"]), jax_step[0],
                                   rtol=LOSS_RTOL)


def test_dp_step_gradients_match_jax(runs):
    """Every gradient leaf (after the all-reduce, on both ranks) within
    1e-4 of the leaf's largest JAX gradient; a leaf whose gradient is zero
    analytically (the frozen embedding) is zero on both sides."""
    jax_step, ranks, _ = runs
    n = 0
    for out in ranks:
        for path, ref, got in _pairs(jax_step[1], out["grads"]):
            scale = float(np.abs(ref).max())
            err = float(np.abs(got - ref).max())
            assert err <= GRAD_RTOL * max(scale, 1e-30), (path, err, scale)
            n += 1
    assert n > 20


def test_dp_step_params_and_batchnorm_stats_match_jax(runs):
    """Parameters after Adam within 1e-5 of JAX's, but for the elements
    whose gradient is within 100x of Adam's eps (1e-8): Adam moves such an
    element by lr x g / (|g| + eps), so the f32 noise of a ~1e-9 gradient
    decides a step of ~lr / 4 (measured 1.1e-4 at lr 1e-3; a few elements
    per leaf); they are held to ADAM_NOISE_ATOL, as in
    ``test_torch_train.py``. The batchnorm running statistics within
    1e-5."""
    jax_step, ranks, _ = runs
    _, grads, new_params, new_state = jax_step
    near_eps = {path: np.abs(g) < ADAM_NOISE_G
                for path, g, _ in _pairs(grads, grads)}
    for out in ranks:
        for path, ref, got in _pairs(new_params, out["params"]):
            d = np.abs(got - ref)
            assert float(d[~near_eps[path]].max(initial=0.0)) <= PARAM_ATOL, \
                path
            assert float(d.max()) <= ADAM_NOISE_ATOL, path
        pairs = list(_pairs(new_state, out["state"]))
        assert len(pairs) == 12    # 4 batchnorms x mean, var, count
        for path, ref, got in pairs:
            assert float(np.abs(got - ref).max()) <= STATS_ATOL, path


def test_dp_ranks_stay_replicated(runs):
    """After the step both ranks hold the same parameters and batchnorm
    statistics, bit for bit."""
    _, ranks, _ = runs
    assert all(float(out["differ"]) == 0.0 for out in ranks)
    for path, a, b in _pairs(ranks[0]["params"], ranks[1]["params"]):
        assert np.array_equal(a, b), path


def test_dp_batchnorm_over_every_position_equals_one_process(runs):
    """R(2+1)D's batchnorm (``layers._BatchNormAll``) with a process
    group: each rank's output and input gradient are the rows of one
    process's batchnorm over the whole input, the scale gradients sum to
    its, and the running statistics are its (the all-reduced sums, count
    and centred squares; the backward's two all-reduced sums)."""
    _, ranks, _ = runs
    ref = _bn_all(None, slice(0, 6))
    got = [out["bn_all"] for out in ranks]
    for k in ("y", "gx"):
        np.testing.assert_allclose(np.concatenate([g[k] for g in got]),
                                   ref[k], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sum(g["gscale"] for g in got), ref["gscale"],
                               rtol=1e-5, atol=1e-6)
    for g in got:
        for k in ("mean", "var"):
            np.testing.assert_allclose(g[k], ref[k], rtol=1e-6, atol=1e-7)


def test_dp_accumulated_step_equals_the_whole_step_in_text_mode(runs):
    """``accum_steps=3`` on the data axis (microbatch i: each rank's i-th
    row) gives the gradients of one step on the whole batch, in mode text
    where no batchnorm couples the rows (as the JAX package's accumulated
    step is exact there)."""
    _, ranks, _ = runs
    for out in ranks:
        assert int(out["text_accum_leaves"]) > 5
        assert float(out["text_accum_worst"]) <= 1e-5


def test_cli_multihost_data_parallel_streaming_epoch(runs):
    """``python -m mmqg_tpu_torch.train --multihost --data-parallel
    --streaming --mode text_video --device cpu``, two processes (the
    streaming loaders pack their own rows' frames): both exit 0, rank 0 alone
    logs the epoch and writes the checkpoints, stats.json (one epoch) and
    config.json; the checkpoint holds finite parameters after the epoch's
    steps."""
    _, _, (cli, results) = runs
    for code, out in results:
        assert code == 0, out
    assert "epoch 0:" in results[0][1] and "Done !" in results[0][1]
    assert "epoch 0:" not in results[1][1]
    assert "data-parallel over 2 processes" in results[1][1]
    stats = json.loads(cli.stats_json_path.read_text())
    assert len(stats["train"]["loss"]) == 1 and len(stats["val"]["bleu"]) == 1
    state = ckpt.load_checkpoint(cli.checkpoint_dir, "last")
    assert int(state["step"]) == -(-12 // cli.batch_size)
    leaves = [x for _, x, _ in _pairs(state["params"], state["params"])]
    assert leaves and all(np.isfinite(x).all() for x in leaves)
    assert ckpt.has_checkpoint(cli.checkpoint_dir, "best")
