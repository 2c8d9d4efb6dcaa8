"""The model axis of the PyTorch port on process grids (gloo on the CPU):
tensor parallelism by JAX's rules (``parallel/model_axis.py``,
``make_train_step(grid=)``), sequence parallelism
(``mesh.sequence_constraint``, ``sp_greedy_decode``,
``ops/attention_sp.py``), ZeRO-1/FSDP composed with a model axis,
GPipe (``parallel/gpipe.py``), the train CLI's ``--sequence-parallel
--sp-gather-free`` with ``mesh_shape`` (1, 2), and ``dryrun_multichip(4)``,
against the JAX package.

One module-scoped run starts every child at once: four ranks as a (2, 2)
grid, two as (1, 2), two CLI ranks and the dry run (four more). The JAX
references run here meanwhile, single-device, in f32: ``loss_fn``'s
gradients (video batchnorm statistics in f64, ``jax_video_stats_f64``, as
``test_torch_multihost.py`` takes them), the greedy tokens of
``decode_batch`` and ``trimodal_attention_xla``.

The model: the tiny text_video model of ``tests/conftest.py`` (hidden 16,
so 4H = 64 splits over 2 and 4) with 40 words, so the vocab projection
splits, a context of 13 (prime: sequence parallelism pads it) and a peaked
decoder (``peaked``, no near-ties for the argmax); f32, no dropout, plain
Adam; a batch of 4 rows (2 a data row on (2, 2)).

Tolerances: each gradient leaf within 1e-4 of its norm plus 1e-6 of the
global norm (the ROADMAP's contract), the loss within 1e-5, the attention
within 1e-6, GPipe within 1e-5 (JAX's bound); ZeRO-1/FSDP on (2, 2) are
the plain (2, 2) step bit for bit, as ``test_torch_zero.py`` holds them
on (2, 1).
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
ROWS, CONTEXT, N_VOCAB, MAX_LEN = 4, 13, 40, 5
GRAD_RTOL, GRAD_GLOBAL, LOSS_RTOL = 1e-4, 1e-6, 1e-5
ATTN_ATOL, PP_TOL = 1e-6, 1e-5
# Adam's normalised step amplifies f32 noise where |g| ~ its eps
PARAM_ATOL, ADAM_NOISE_G, ADAM_NOISE_ATOL = 1e-5, 1e-6, 5e-4
CHILD_TIMEOUT = 300
GRIDS = {"2x2": (2, 2), "1x2": (1, 2)}
STEPS = {"tp": {}, "sp": {"sp": True},
         "sp_gather_free": {"sp": True, "sp_gather_free": True},
         "zero1": {"zero1": True}, "fsdp": {"fsdp": True}}
GRAD_STEPS = ("tp", "sp", "sp_gather_free")
# plain Adam: a clip would scale the update by a norm that the sharded
# steps sum in another order (their grad_norm metric is still compared)
OPTIM = dict(optim="adam", lr=1e-3, grad_clip_norm=0.0)
ATTN_LENGTHS = (12, 13)


def _opt_config() -> SimpleNamespace:
    base = dict(weight_decay=0.0, lr_schedule="constant", lr_warmup_steps=0,
                lr_decay_steps=0, lr_min_ratio=0.0, text_non_trainable=False)
    base.update(OPTIM)
    return SimpleNamespace(**base)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"     # the suite runs several files at once
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


def _popen(args):
    return subprocess.Popen(args, cwd=REPO, env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _child_cmd(fn: str, *args) -> list:
    return [sys.executable, "-c", "import sys; from tests."
            f"test_torch_model_axis_grid import {fn}; {fn}(*sys.argv[1:])",
            *map(str, args)]


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

def _by_path(tree, fn):
    from mmqg_tpu_torch.optim import tree_map_with_path
    return tree_map_with_path(fn, tree)


def _grid_child(rank: str, world: str, shape: str, coordinator: str,
                data_dir: str) -> None:
    """One rank of a grid: the steps of every mode, the checkpoints, the
    decodes, the attention and GPipe, into ``<data_dir>/<shape>-r<rank>``."""
    import torch.distributed as dist

    from mmqg_tpu_torch import decode as DEC
    from mmqg_tpu_torch.compat.from_jax import (params_from_numpy,
                                                tree_to_numpy)
    from mmqg_tpu_torch.dryrun import gpipe_deltas
    from mmqg_tpu_torch.models import qg_model as TQ
    from mmqg_tpu_torch.ops.attention import TriModalAttention
    from mmqg_tpu_torch.ops.attention_sp import trimodal_attention_sp
    from mmqg_tpu_torch.optim import Transform, make_optimizer
    from mmqg_tpu_torch.parallel import model_axis, multihost as MH, zero
    from mmqg_tpu_torch.parallel.mesh import row_block, sp_greedy_decode
    from mmqg_tpu_torch.train import TrainState, make_train_step, to_device

    torch.set_num_threads(1)
    rank, world, d = int(rank), int(world), Path(data_dir)
    shape = tuple(int(x) for x in shape.split("x"))
    MH.initialize_multihost(coordinator, world, rank, device="cpu",
                            timeout_s=CHILD_TIMEOUT)
    grid = MH.Grid(shape)
    data = grid.data_group if grid.dp > 1 else None
    inp = ckpt.msgpack_restore((d / "inputs.msgpack").read_bytes())
    mc = TQ.ModelConfig(**json.loads((d / "mc.json").read_text()))
    lo, hi = row_block(grid.data_index, grid.dp, ROWS)
    batch = to_device({k: v[lo:hi] for k, v in inp["batch"].items()}, "cpu")
    base = make_optimizer(_opt_config())

    def fresh():
        model = params_from_numpy(inp["params"], inp["model_state"], "cpu",
                                  trainable=True)
        TQ.set_process_group(model, data)
        return model

    def whole(tp, path, x):
        d_ = tp.dims.get(path)
        return x if d_ is None else model_axis.gather_along(x, d_, tp.group)

    out = {"data_index": grid.data_index, "model_index": grid.model_index}
    for name, kw in STEPS.items():
        if name in ("zero1", "fsdp") and grid.dp == 1:
            continue
        grads = []

        def update(g, s, p):
            grads.append(g)
            return base.update(g, s, p)
        opt = Transform(base.init, update)
        model = fresh()
        ts = TrainState(model, opt.init(TQ.param_tree(model)))
        step = make_train_step(
            mc, opt, dtype=torch.float32, grid=grid,
            sp_mesh=grid if kw.get("sp") else None,
            sp_gather_free=kw.get("sp_gather_free", False),
            zero1=kw.get("zero1", False), fsdp=kw.get("fsdp", False))
        ts, m = step(ts, batch, None)
        tp = ts.model.tp
        res = {"loss": np.float64(m["loss"]),
               "grad_norm": np.float64(m["grad_norm"]),
               "held": {k: np.int64(v) for k, v in
                        zero.held_bytes(ts).items()},
               "state": tp.host_state(ts)}
        if name in GRAD_STEPS:
            res["grads"] = tree_to_numpy(_by_path(
                grads[0], lambda path, g: whole(tp, path, g)))
        if name == "tp":
            res["slices"] = tree_to_numpy(TQ.param_tree(ts.model))
            ckpt.save_checkpoint(d / f"{'x'.join(map(str, shape))}-ckpt",
                                 "last", res["state"] if rank == 0 else None,
                                 group=dist.group.WORLD)
            # resume: a fresh grid state loads the file and re-slices
            again = fresh()
            ts2 = TrainState(again, base.init(TQ.param_tree(again)))
            model_axis.shard(ts2, grid)
            ts2.model.tp.load(ts2, ckpt.load_checkpoint(
                d / f"{'x'.join(map(str, shape))}-ckpt", "last"))
            res["resumed_equal"] = np.bool_(all(
                torch.equal(a, b) for a, b in zip(
                    _leaves(TQ.param_tree(ts2.model))
                    + _leaves(ts2.opt_state),
                    _leaves(TQ.param_tree(ts.model)) + _leaves(ts.opt_state))))
        out[name] = res

    # the sharded checkpoint of a fresh state, before any step
    model = fresh()
    ts = TrainState(model, base.init(TQ.param_tree(model)))
    model_axis.shard(ts, grid)
    host = ts.model.tp.host_state(ts)               # a collective
    ckpt.save_checkpoint(d / f"{'x'.join(map(str, shape))}-init", "init",
                         host if rank == 0 else None, group=dist.group.WORLD)

    # greedy decodes of the fresh grid model: the column-parallel vocab,
    # and sequence parallelism in both modes
    with torch.no_grad(), model_axis.whole(ts.model):
        toks = DEC.decode_batch(ts.model, mc, batch, strategy="greedy",
                                max_len=MAX_LEN, dtype=torch.float32)
    def rows(x):            # every data row's, in order
        return MH.to_host(x, data) if data is not None else x.numpy()
    out["tokens"] = rows(toks)
    for name, gf in (("tokens_sp_gather", False),
                     ("tokens_sp_gather_free", True)):
        out[name] = rows(sp_greedy_decode(
            ts.model, mc, batch, grid, max_len=MAX_LEN, gather_free=gf,
            dtype=torch.float32))

    # trimodal_attention_sp on whole inputs, at two context lengths
    out["attn"] = {}
    for lt in ATTN_LENGTHS:
        a = {k: torch.from_numpy(np.asarray(v)) for k, v in
             inp["attn"][str(lt)].items()}
        attn = TriModalAttention(*(a[k] for k in TQ.ATTN_FIELDS))
        block = model_axis.SequenceConstraint(grid.model_group)(
            a["enc_text"])
        ctx_t, ctx_a, ctx_v, maps = trimodal_attention_sp(
            attn, a["query"], block, a["enc_video"], a["enc_audio"],
            a["text_len"], a["video_len"], a["audio_len"],
            group=grid.model_group, dtype=torch.float32)
        out["attn"][str(lt)] = {
            "ctx_t": ctx_t.numpy(), "ctx_a": ctx_a.numpy(),
            "ctx_v": ctx_v.numpy(),
            "text": model_axis.gather_along(maps["text"], 1,
                                            grid.model_group).numpy(),
            "audio": maps["audio"].numpy(), "video": maps["video"].numpy()}

    # GPipe over the model axis, each data row on its rows (DP x PP)
    cpu = torch.device("cpu")
    out["gpipe"] = {f"{shape[0]}x{shape[1]}": gpipe_deltas(grid, cpu)}
    if world == 4:
        out["gpipe"]["1x4"] = gpipe_deltas(MH.Grid((1, 4)), cpu)
    (d / f"{'x'.join(map(str, shape))}-r{rank}.msgpack").write_bytes(
        ckpt.msgpack_serialize(out))
    dist.destroy_process_group()


def _leaves(tree):
    from mmqg_tpu_torch.optim import tree_leaves
    return [x.detach() for x in tree_leaves(tree)]


# ---------------------------------------------------------------- fixtures

def _model(tiny_config):
    """The port's ModelConfig and the numpy (params, state) of the tiny
    text_video model with a context of 13 and a peaked decoder."""
    from mmqg_tpu_torch.models import qg_model as TQ
    from tests.torch_port_fixtures import peaked, tiny_model

    cfg = tiny_config.replace(context_max_length=CONTEXT)
    mc, params, state = tiny_model(cfg, n_vocab=N_VOCAB, seed=6)
    mc = TQ.ModelConfig(**mc._replace(mode="text_video", dropout=0.0,
                                      text_dropout=0.0)._asdict())
    params.pop("audio_enc")
    params = peaked(params, end_twin=5)
    params["decoder"]["attn"] = params["decoder"]["attn"]._asdict()
    return mc, params, state


def _batch(mc) -> dict:
    from tests.torch_port_fixtures import tiny_batch

    b = tiny_batch(mc, B=ROWS, seed=11)
    b["context_len"] = np.asarray([13, 5, 9, 1], np.int32)
    b["frames_len"] = np.asarray([3, 1, 2, 3], np.int32)
    rng = np.random.RandomState(3)
    b["target_ids"] = rng.randint(3, mc.n_vocab, (ROWS, mc.target_steps)
                                  ).astype(np.int32)
    b["target_len"] = np.asarray([4, 7, 2, 5], np.int32)
    b["valid"] = np.ones(ROWS, bool)
    return b


def _attn_inputs() -> dict:
    """Seeded inputs of one attention step at each context length."""
    out = {}
    for lt in ATTN_LENGTHS:
        rng = np.random.RandomState(lt)
        B, Dq, La, Ht, Hv, Ha = 4, 24, 3, 16, 16, 8

        def f32(*shape):
            return rng.randn(*shape).astype(np.float32)
        out[str(lt)] = {
            "w_text": f32(Dq, lt), "b_text": f32(lt),
            "w_video": f32(Dq, La), "b_video": f32(La),
            "w_audio": f32(Dq, La), "b_audio": f32(La),
            "query": f32(B, Dq), "enc_text": f32(B, lt, Ht),
            "enc_video": f32(B, La, Hv), "enc_audio": f32(B, La, Ha),
            "text_len": np.asarray([lt, 1, lt - 3, 7], np.int32),
            "video_len": np.asarray([3, 1, 2, 3], np.int32),
            "audio_len": np.asarray([1, 3, 2, 3], np.int32)}
    return out


def _jax_refs(mc, params, state, batch, attn_inputs) -> dict:
    """JAX's f32 single-device gradients, loss and greedy tokens, and its
    attention on the seeded inputs."""
    import jax
    import jax.numpy as jnp

    from mmqg_tpu import decode as JDEC
    from mmqg_tpu.models import qg_model as JQ
    from mmqg_tpu.ops.attention import AttnParams, trimodal_attention_xla
    from tests.torch_port_fixtures import jax_video_stats_f64

    jmc = JQ.ModelConfig(**mc._asdict())
    p = dict(params, decoder=dict(params["decoder"], attn=AttnParams(
        **params["decoder"]["attn"])))
    p = jax.tree.map(jnp.asarray, p)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with jax_video_stats_f64():
        def f(pp):
            return JQ.loss_fn(pp, state, jmc, jb, train=True,
                              dtype=jnp.float32)
        (obj, aux), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(p)
    grads = jax.tree.map(np.asarray, grads)
    grads["decoder"]["attn"] = grads["decoder"]["attn"]._asdict()
    toks = np.asarray(JDEC.decode_batch(
        p, state, jmc, {k: v for k, v in jb.items()},
        jax.random.PRNGKey(0), strategy="greedy", max_len=MAX_LEN,
        use_pallas=False, dtype=jnp.float32))
    attn = {}
    for lt, a in attn_inputs.items():
        ap = AttnParams(*(jnp.asarray(a[k]) for k in AttnParams._fields))
        ctx_t, ctx_a, ctx_v, maps = trimodal_attention_xla(
            ap, *(jnp.asarray(a[k]) for k in (
                "query", "enc_text", "enc_video", "enc_audio", "text_len",
                "video_len", "audio_len")), dtype=jnp.float32)
        attn[lt] = {"ctx_t": ctx_t, "ctx_a": ctx_a, "ctx_v": ctx_v,
                    **{k: maps[k] for k in ("text", "audio", "video")}}
    return {"loss": float(aux["loss_per_sample"]), "grads": grads,
            "tokens": toks,
            "attn": jax.tree.map(np.asarray, attn)}


def _one_process(mc, params, state, batch, d: Path) -> dict:
    """The port's one-process f32 step on the whole batch (gradients,
    loss, the updated state) and its init checkpoint's bytes."""
    from mmqg_tpu_torch.compat.from_jax import (params_from_numpy,
                                                train_state_to_numpy,
                                                tree_to_numpy)
    from mmqg_tpu_torch.models import qg_model as TQ
    from mmqg_tpu_torch.optim import Transform, make_optimizer
    from mmqg_tpu_torch.train import TrainState, make_train_step, to_device

    base = make_optimizer(_opt_config())
    grads = []

    def update(g, s, p):
        grads.append(tree_to_numpy(g))
        return base.update(g, s, p)
    opt = Transform(base.init, update)
    model = params_from_numpy(params, state, "cpu", trainable=True)
    ts = TrainState(model, opt.init(TQ.param_tree(model)))
    ckpt.save_checkpoint(d / "single-init", "init", train_state_to_numpy(
        ts.model, ts.opt_state, ts.step))
    ts, m = make_train_step(mc, opt, dtype=torch.float32)(
        ts, to_device(batch, "cpu"), None)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "grads": grads[0],
            "state": train_state_to_numpy(ts.model, ts.opt_state, ts.step),
            "init_bytes": (d / "single-init" / "init.msgpack").read_bytes()}


@pytest.fixture(scope="module")
def runs(tiny_config, tiny_corpus, tmp_path_factory):
    """Start every child; meanwhile the JAX references and one process's
    step. Returns what they wrote."""
    from mmqg_tpu_torch.config import Config
    from tests.torch_port_fixtures import drop_checkpoints

    d = tmp_path_factory.mktemp("model_axis")
    mc, params, state = _model(tiny_config)
    batch = _batch(mc)
    attn_inputs = _attn_inputs()
    (d / "mc.json").write_text(json.dumps(mc._asdict()))
    (d / "inputs.msgpack").write_bytes(ckpt.msgpack_serialize(
        {"params": params, "model_state": state, "batch": batch,
         "attn": attn_inputs}))
    cli = Config.load(tiny_config.save(d / "tiny.json")).replace(
        output_path=d / "cli" / "results", mesh_shape=(1, 2),
        text_lstm_dropout=0.0, dec_lstm_dropout=0.0)
    cli.ensure_dirs()
    procs = []
    for name, (dp, tp) in GRIDS.items():
        port = _free_port()
        procs += [_popen(_child_cmd("_grid_child", r, dp * tp, name,
                                    f"localhost:{port}", d))
                  for r in range(dp * tp)]
    port = _free_port()
    procs += [_popen([sys.executable, "-m", "mmqg_tpu_torch.train", "-c",
                      str(cli.save()), "--epochs", "1", "--device", "cpu",
                      "--mode", "text_video", "--multihost",
                      "--data-parallel", "--sequence-parallel",
                      "--sp-gather-free", "--coordinator",
                      f"localhost:{port}", "--num-processes", "2",
                      "--process-id", str(r)]) for r in range(2)]
    procs.append(_popen([sys.executable, "-c", "from mmqg_tpu_torch.dryrun "
                         "import dryrun_multichip; "
                         "dryrun_multichip(4, device='cpu')"]))
    try:        # the references, while the children run
        jax_ref = _jax_refs(mc, params, state, batch, attn_inputs)
        single = _one_process(mc, params, state, batch, d)
    finally:
        results = _wait(procs)
    n_grid = sum(dp * tp for dp, tp in GRIDS.values())
    for code, out in results[:n_grid]:
        assert code == 0, out
    ranks = {name: [ckpt.msgpack_restore((d / f"{name}-r{r}.msgpack")
                                         .read_bytes())
                    for r in range(dp * tp)]
             for name, (dp, tp) in GRIDS.items()}
    files = {name: {what: (d / f"{name}-{what}" / f"{alias}.msgpack")
                    .read_bytes() for what, alias in (("init", "init"),
                                                      ("ckpt", "last"))}
             for name in GRIDS}
    cli_state = (ckpt.load_checkpoint(cli.checkpoint_dir, "last")
                 if ckpt.has_checkpoint(cli.checkpoint_dir, "last") else None)
    drop_checkpoints(d)
    return SimpleNamespace(
        mc=mc, params=params, batch=batch, jax=jax_ref, single=single,
        ranks=ranks, files=files, cli=cli, cli_state=cli_state,
        cli_results=results[n_grid:n_grid + 2], dryrun=results[-1])


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
        yield path, np.asarray(a, np.float64), np.asarray(b, np.float64)


def _check_grads(got, ref) -> int:
    pairs = list(_pairs(ref, got))
    total = np.sqrt(sum(float(np.sum(r * r)) for _, r, _ in pairs))
    for path, r, g in pairs:
        assert g.shape == r.shape, path
        err = float(np.linalg.norm(g - r))
        assert err <= GRAD_RTOL * float(np.linalg.norm(r)) \
            + GRAD_GLOBAL * total, (path, err, float(np.linalg.norm(r)))
    return len(pairs)


# ------------------------------------------------------------------- tests

@pytest.mark.parametrize("step", GRAD_STEPS)
@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("reference", ["jax", "one_process"])
def test_grid_step_gradients_match_the_single_device_gradients(
        runs, grid, step, reference):
    """The tensor-parallel step, and both sequence-parallel ones, on each
    grid: every rank's gradient (its slices gathered over the model axis,
    summed over the data axis) within 1e-4 of each leaf's norm plus 1e-6
    of the global norm of JAX's single-device ``value_and_grad`` and of
    the port's one-process step; the loss within 1e-5."""
    ref = runs.jax if reference == "jax" else runs.single
    for out in runs.ranks[grid]:
        assert _check_grads(out[step]["grads"], ref["grads"]) > 20
        np.testing.assert_allclose(float(out[step]["loss"]), ref["loss"],
                                   rtol=LOSS_RTOL)
    if reference == "one_process":
        for out in runs.ranks[grid]:
            np.testing.assert_allclose(float(out[step]["grad_norm"]),
                                       runs.single["grad_norm"],
                                       rtol=LOSS_RTOL)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_ranks_hold_the_one_process_update_sliced_by_the_rule(runs, grid):
    """Between steps each rank holds, of every split parameter, its slice
    (``param_shardings``) of the one-process update, and the bytes of the
    rule's share of the parameters and the optimizer state."""
    from mmqg_tpu_torch.parallel import zero
    from mmqg_tpu_torch.parallel.mesh import model_dims

    shape = GRIDS[grid]
    meta = _meta(runs.single["state"]["params"])
    dims = dict(_flat(model_dims(meta, shape)))
    want_bytes = {"params": zero.grid_rule_bytes(meta, shape, data=False),
                  "opt_state": zero.grid_rule_bytes(
                      _meta(runs.single["state"]["opt_state"]), shape,
                      data=False)}
    near_eps = {path: np.abs(g) < ADAM_NOISE_G for path, g, _ in
                _pairs(runs.single["grads"], runs.single["grads"])}
    n_split = 0
    for out in runs.ranks[grid]:
        assert {k: int(v) for k, v in out["tp"]["held"].items()} \
            == want_bytes
        j = int(out["model_index"])
        for path, full, got in _pairs(runs.single["state"]["params"],
                                      out["tp"]["slices"]):
            d = dims[tuple(_key(k) for k in path.strip("/").split("/"))]
            want, noise = full, near_eps[path]
            if d is not None:
                n = full.shape[d] // shape[1]
                want = np.take(full, range(j * n, (j + 1) * n), axis=d)
                noise = np.take(noise, range(j * n, (j + 1) * n), axis=d)
                n_split += 1
            assert got.shape == want.shape, path
            diff = np.abs(got - want)
            assert float(diff[~noise].max(initial=0.0)) <= PARAM_ATOL, path
            assert float(diff.max(initial=0.0)) <= ADAM_NOISE_ATOL, path
    assert n_split > 10


def _key(k: str):
    return int(k) if k.isdigit() else k


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, prefix + (i,))
    else:
        yield prefix, tree


def _meta(tree):
    from mmqg_tpu_torch.optim import tree_map
    return tree_map(lambda a: torch.empty(np.shape(a), device="meta"), tree)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_grid_checkpoints_are_one_process_bytes_and_resume_reslices(
        runs, grid):
    """The msgpack the grid's primary writes of a fresh state stored over
    the model axis is the one-process file, byte for byte; after a step,
    a fresh grid state that loads the grid's file holds every rank's
    slices and optimizer state exactly."""
    assert runs.files[grid]["init"] == runs.single["init_bytes"]
    for out in runs.ranks[grid]:
        assert bool(out["tp"]["resumed_equal"])


@pytest.mark.parametrize("mode", ["zero1", "fsdp"])
def test_zero_on_a_model_axis_equals_the_plain_grid_step(runs, mode):
    """ZeRO-1 and FSDP on the (2, 2) grid: the gathered state is the plain
    (2, 2) step's bit for bit, and each rank holds its share of both
    axes' splits."""
    from mmqg_tpu_torch.parallel import zero

    meta = {k: _meta(runs.single["state"][k]) for k in ("params",
                                                         "opt_state")}
    want = {"opt_state": zero.grid_rule_bytes(meta["opt_state"], (2, 2)),
            "params": zero.grid_rule_bytes(meta["params"], (2, 2),
                                           data=mode == "fsdp")}
    assert want["opt_state"] < 0.4 * zero.grid_rule_bytes(
        meta["opt_state"], (1, 1))
    for out in runs.ranks["2x2"]:
        for path, a, b in _pairs(out[mode]["state"], out["tp"]["state"]):
            assert np.array_equal(a, b), path
        assert float(out[mode]["loss"]) == float(out["tp"]["loss"])
        assert {k: int(v) for k, v in out[mode]["held"].items()} == want


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("decode", ["tokens", "tokens_sp_gather",
                                    "tokens_sp_gather_free"])
def test_grid_greedy_tokens_equal_jax(runs, grid, decode):
    """The grid's greedy decode (column-parallel vocab) and
    ``sp_greedy_decode`` in both modes give JAX's ``decode_batch`` tokens
    (f32), every row, on every rank."""
    key = decode
    for out in runs.ranks[grid]:
        np.testing.assert_array_equal(out[key], runs.jax["tokens"])
    assert (runs.jax["tokens"] > 2).sum() > 4


@pytest.mark.parametrize("lt", [str(x) for x in ATTN_LENGTHS])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_attention_sp_matches_jax_xla(runs, grid, lt):
    """``trimodal_attention_sp`` over the model axis (the context of 13
    padded to 14) against JAX's ``trimodal_attention_xla`` in f32: the
    three contexts and the three maps within 1e-6."""
    ref = runs.jax["attn"][lt]
    for out in runs.ranks[grid]:
        got = out["attn"][lt]
        for k in ("ctx_t", "ctx_a", "ctx_v", "audio", "video"):
            np.testing.assert_allclose(got[k], ref[k], atol=ATTN_ATOL,
                                       err_msg=k)
        np.testing.assert_allclose(got["text"][:, :int(lt)], ref["text"],
                                   atol=ATTN_ATOL)
        assert not np.any(got["text"][:, int(lt):])


@pytest.mark.parametrize("case", ["2x2", "1x4", "1x2"])
def test_gpipe_matches_the_sequential_stack(runs, case):
    """GPipe's forward and its stacked parameters' gradients within 1e-5 of
    the sequential stack's: 2 stages x 2 data rows (DP x PP), 4 stages,
    2 stages."""
    grid = "1x2" if case == "1x2" else "2x2"
    for out in runs.ranks[grid]:
        got = out["gpipe"][case]
        assert int(got["stages"]) == int(case[-1])
        assert float(got["fwd"]) <= PP_TOL and float(got["grad"]) <= PP_TOL


def test_train_cli_with_sequence_parallelism_on_a_model_axis(runs):
    """``train --multihost --data-parallel --sequence-parallel
    --sp-gather-free`` with ``mesh_shape`` (1, 2): both ranks exit 0, rank
    0 logs the mesh and the epoch and writes a checkpoint of the whole
    (gathered) state."""
    for code, out in runs.cli_results:
        assert code == 0, out
    log = runs.cli_results[0][1]
    assert "mesh (data, model) (1, 2)" in log and "Done !" in log
    assert "epoch 0:" not in runs.cli_results[1][1]
    state = runs.cli_state
    assert state is not None and int(state["step"]) > 0
    assert state["params"]["decoder"]["lstm"]["layers"][0]["wx"].shape[1] \
        == 4 * runs.cli.dec_lstm_hidden_dim
    assert runs.cli.stats_json_path.exists()


def test_dryrun_multichip_on_four_cpu_processes(runs):
    """``dryrun_multichip(4, device="cpu")``: a (2, 2) grid of gloo
    processes passes every check and prints its deltas."""
    code, out = runs.dryrun
    assert code == 0, out
    assert "dryrun_multichip OK: mesh=(2 data, 2 model), gloo on cpu" in out
