"""The model axis of the PyTorch port in one process, against the JAX
package: the tensor-parallel rules (``mesh.param_shardings``,
``audit_tp_coverage``, ``zero1_shardings``/``fsdp_shardings`` on a
(data, model) mesh), serving with the rules (``QGPipeline.shard(shape=)``,
``evaluate(mesh=)``), the vocab reductions, GPipe's input checks and the
train CLI's ``--sp-gather-free`` check. The process grids are
``test_torch_model_axis_grid.py``'s.

The rules: JAX's specs come from a child with eight host devices (shapes
only: nothing runs there), on (2, 2) and (4, 2) meshes, for the tiny
tri-modal model with the conv-LSTM and with R(2+1)D-18 and their Adam
states. Serving: the tiny model with a peaked decoder in f32 on CPU
"devices", its questions equal to the JAX pipeline's.
"""

import copy
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mmqg_tpu_torch.models import qg_model as TQ
from mmqg_tpu_torch.optim import make_optimizer, tree_map
from mmqg_tpu_torch.parallel import make_mesh
from mmqg_tpu_torch.parallel.mesh import (audit_tp_coverage, fsdp_shardings,
                                          grid_specs, param_shardings,
                                          zero1_shardings)

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
MESHES = {"2x2": (2, 2), "4x2": (4, 2)}
CHILD_TIMEOUT = 240
ADAM = SimpleNamespace(lr=1e-3, optim="adam", grad_clip_norm=0.0,
                       weight_decay=0.0, lr_schedule="constant",
                       lr_warmup_steps=0, lr_decay_steps=0, lr_min_ratio=0.0,
                       text_non_trainable=False)


def _shape_tree(tree):
    if isinstance(tree, dict):
        return {k: _shape_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shape_tree(v) for v in tree]
    return {"__shape__": list(np.shape(tree))}


def _flat(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix.rstrip("/"): tree}


def _jax_specs_child(spec_path: str, out_path: str) -> None:
    """JAX's param_shardings, fsdp_shardings and zero1_shardings on each
    mesh of MESHES (host devices), for the shapes of ``spec_path``: each
    leaf's spec, padded to its rank, by state-dict path."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from flax import serialization

    from mmqg_tpu import train as JT
    from mmqg_tpu.parallel.mesh import (fsdp_shardings as jf,
                                        make_mesh as jmesh,
                                        param_shardings as jp,
                                        zero1_shardings as jz)

    def shapes(node):
        if isinstance(node, dict) and "__shape__" in node:
            return jax.ShapeDtypeStruct(tuple(node["__shape__"]), np.float32)
        if isinstance(node, dict):
            return {k: shapes(v) for k, v in node.items()}
        return [shapes(v) for v in node]

    def specs(tree, ref, prefix=""):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                out.update(specs(v, ref[k], f"{prefix}{k}/"))
            return out
        spec = list(tree.spec) + [None] * (len(ref.shape) - len(tree.spec))
        return {prefix.rstrip("/"): spec}

    def state_dict(x):
        return serialization.to_state_dict(x)

    out = {}
    for case in json.loads(Path(spec_path).read_text()):
        params = shapes(case["params"])
        opt_state = jax.eval_shape(JT.make_optimizer(ADAM).init, params)
        for name, shape in MESHES.items():
            n = shape[0] * shape[1]
            mesh = jmesh(shape, devices=jax.devices()[:n])
            sd_p, sd_o = state_dict(params), state_dict(opt_state)
            out[f"{case['name']}/{name}"] = {
                "params": specs(state_dict(jp(params, mesh)), sd_p),
                "fsdp": specs(state_dict(jf(params, mesh)), sd_p),
                "zero1": specs(state_dict(jz(opt_state, mesh)), sd_o)}
    Path(out_path).write_text(json.dumps(out))


@pytest.fixture(scope="module")
def rules(tiny_config, tmp_path_factory):
    """The port's specs and JAX's (from the child), by case and mesh."""
    d = tmp_path_factory.mktemp("rules")
    cases, port = [], {}
    for venc in ("conv_lstm", "resnet"):
        mc = TQ.ModelConfig.from_config(
            tiny_config.replace(video_encoder=venc), n_vocab=40,
            mode="trimodal")
        params, _ = TQ.init_params(mc, 0)
        meta = tree_map(lambda a: torch.empty(a.shape, device="meta"),
                        params)
        opt_state = make_optimizer(ADAM).init(meta)
        cases.append({"name": venc, "params": _shape_tree(params)})
        for name, shape in MESHES.items():
            ndim = {k: x.ndim for k, x in _flat(meta).items()}
            port[f"{venc}/{name}"] = {
                "params": {k: list(v) + [None] * (ndim[k] - len(v))
                           for k, v in _flat(param_shardings(
                               meta, shape)).items()},
                "fsdp": _flat(grid_specs(meta, shape)),
                "zero1": _flat(grid_specs(opt_state, shape)),
                "fsdp_dims": _flat(fsdp_shardings(meta, shape)),
                "zero1_dims": _flat(zero1_shardings(opt_state, shape))}
    spec, out = d / "spec.json", d / "jax.json"
    spec.write_text(json.dumps(cases))
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    proc = subprocess.run(
        [sys.executable, "-c", "import sys; from tests.test_torch_model_axis "
         "import _jax_specs_child; _jax_specs_child(*sys.argv[1:])",
         str(spec), str(out)], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=CHILD_TIMEOUT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return port, json.loads(out.read_text())


@pytest.mark.parametrize("what", ["params", "fsdp", "zero1"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("venc", ["conv_lstm", "resnet"])
def test_specs_equal_jax_leaf_for_leaf(rules, venc, mesh, what):
    """param_shardings (the model axis, with the divisibility fixup) and
    the data-axis widening of fsdp_shardings / zero1_shardings give every
    leaf JAX's spec on the mesh; the split dimensions that
    fsdp_shardings / zero1_shardings return are the specs' "data"."""
    port, ref = rules
    got = port[f"{venc}/{mesh}"][what]
    want = ref[f"{venc}/{mesh}"][what]
    assert set(got) == set(want)
    bad = {k: (list(got[k]), want[k]) for k in got
           if list(got[k]) != want[k]}
    assert not bad, bad
    assert any("model" in s for s in got.values())
    if what != "params":
        dims = port[f"{venc}/{mesh}"][f"{what}_dims"]
        assert dims == {k: s.index("data") if "data" in s else None
                        for k, s in got.items()}
        assert any(d is not None for d in dims.values())


def test_audit_covers_the_model_and_flags_a_renamed_leaf(tiny_config):
    """Every leaf of 2+ dims of both backbones and the Adam state gets a
    rule or is allowlisted (the size floor lowered to 64 so the tiny
    leaves are in scope); a big matrix no rule names is reported and
    makes param_shardings raise with JAX's message; a mesh without a
    model axis audits nothing (JAX ``parallel_cases.py:935-980``)."""
    mesh = make_mesh((4, 2), devices=["cpu"] * 8)
    for venc in ("conv_lstm", "resnet"):
        mc = TQ.ModelConfig.from_config(
            tiny_config.replace(video_encoder=venc), n_vocab=40,
            mode="trimodal")
        params, _ = TQ.init_params(mc, 0)
        meta = tree_map(lambda a: torch.empty(a.shape, device="meta"),
                        params)
        assert audit_tp_coverage(meta, mesh, min_elements=64) == []
        opt_state = make_optimizer(ADAM).init(meta)
        assert audit_tp_coverage(opt_state, mesh, min_elements=64) == []
    stray = {"mystery": {"big_matrix": torch.zeros(128, 128)}}
    assert audit_tp_coverage(stray, mesh) == ["mystery/big_matrix (128, 128)"]
    with pytest.raises(ValueError, match="rename drift.*mystery/big_matrix"):
        param_shardings(stray, mesh)
    assert audit_tp_coverage(stray, make_mesh((8, 1),
                                              devices=["cpu"] * 8)) == []


# ------------------------------------------------------------------ serving

@pytest.fixture(scope="module")
def pipes(tiny_config):
    """(JAX pipeline, port), f32, the tiny tri-modal model with a peaked
    decoder."""
    from tests.torch_port_fixtures import f32_pipelines

    with f32_pipelines(tiny_config) as pair:
        yield pair


@pytest.mark.parametrize("strategy", ["greedy", "beam"])
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_shard_with_a_model_axis_answers_as_jax(pipes, tiny_config, shape,
                                                strategy):
    """``shard(shape=)`` over CPU devices: one replica per data row, its
    split leaves stored over the row's devices (empty on the replica
    between batches, the row's devices holding equal shares) and
    gathered for each batch; the questions of 5 and 8 requests are the
    JAX pipeline's."""
    from tests.test_torch_parallel import _jax_questions, _requests
    from tests.torch_port_fixtures import WORDS

    jax_pipe, port = pipes
    sharded = copy.copy(port).shard(shape=shape,
                                    devices=["cpu"] * (shape[0] * shape[1]))
    try:
        stores = sharded.replicas.stores
        assert len(stores) == shape[0] and len(sharded.replicas.models) \
            == shape[0]
        held = stores[0].held_bytes()
        assert len(held) == shape[1] and len(set(held)) == 1 and held[0] > 0
        assert all(p.numel() == 0 for p, _ in stores[0].split)
        for n in (5, 8):
            req = _requests(tiny_config, n, 20 + n, WORDS)
            kw = {"beam_size": 4} if strategy == "beam" else {}
            got = sharded.generate(*req, strategy=strategy, **kw)
            assert got == _jax_questions(jax_pipe, "trimodal", n, req,
                                         strategy)
    finally:
        sharded.replicas.close()
    # the pipeline's own model stays whole
    assert all(p.numel() > 0 for p in tree_leaves_of(port.model))


def tree_leaves_of(model):
    from mmqg_tpu_torch.optim import tree_leaves
    return tree_leaves(TQ.param_tree(model))


def test_evaluate_on_a_model_axis_mesh_equals_unsharded(tiny_config,
                                                        tiny_corpus):
    """``evaluate(mesh=)`` on a (1, 2) mesh of CPU devices: the
    predictions and the BLEU suite of the unsharded evaluate."""
    from mmqg_tpu_torch import evaluate as EV
    from mmqg_tpu_torch.compat.from_jax import params_from_numpy
    from mmqg_tpu_torch.data.dataset import QGDataset

    ds = QGDataset(tiny_config, tiny_config.test_file)
    mc = TQ.ModelConfig.from_config(tiny_config, n_vocab=len(ds.vocab),
                                    mode="trimodal")
    params, state = TQ.init_params(mc, 2)
    model = params_from_numpy(params, state, "cpu")
    for strategy in ("greedy", "beam"):
        kw = dict(strategy=strategy, batch_size=3, pred_max_len=5)
        ref = EV.evaluate(model, mc, ds, **kw)
        got = EV.evaluate(model, mc, ds, mesh=make_mesh(
            (1, 2), devices=["cpu", "cpu"]), **kw)
        assert got == ref


# ------------------------------------------------------- smaller pieces

def test_vocab_reductions_without_a_group_are_the_plain_ones():
    """``model_axis.log_prob`` and ``argmax`` without a group are
    ``log_softmax`` + gather and ``torch.argmax`` (first index on ties);
    the sequence constraint of a one-rank group pads nothing and gives
    the memory back."""
    from mmqg_tpu_torch.parallel import model_axis

    rng = np.random.RandomState(0)
    logits = torch.tensor(rng.randn(3, 4, 11), dtype=torch.float32)
    logits[0, 0, 2] = logits[0, 0, 7] = 50.0
    target = torch.tensor(rng.randint(0, 11, (3, 4)))
    want = torch.log_softmax(logits, -1).gather(-1, target[..., None])[..., 0]
    assert torch.equal(model_axis.log_prob(logits, target), want)
    assert torch.equal(model_axis.argmax(logits), torch.argmax(logits, -1))
    assert int(model_axis.argmax(logits)[0, 0]) == 2
    mem = torch.tensor(rng.randn(2, 13, 5), dtype=torch.float32)
    sc = model_axis.SequenceConstraint(None)
    assert torch.equal(sc.gather(sc(mem), 13), mem)


def test_gpipe_input_checks_and_microbatch_round_trip():
    """``microbatch``/``unmicrobatch`` round-trip and refuse an indivisible
    batch; ``gpipe`` refuses stage parameters whose leading dimension is
    not the number of stages and a stage that changes the activation's
    shape (JAX ``parallel_cases.py:847-932``); one stage is the stage."""
    from mmqg_tpu_torch.parallel.gpipe import (gpipe, microbatch,
                                               stack_stage_params,
                                               unmicrobatch)

    x = torch.arange(24.0).reshape(6, 4)
    xs = microbatch(x, 3)
    assert tuple(xs.shape) == (3, 2, 4)
    assert torch.equal(unmicrobatch(xs), x)
    with pytest.raises(ValueError, match="not divisible"):
        microbatch(x, 4)
    w = torch.eye(4)
    with pytest.raises(ValueError, match="leading dim"):
        gpipe(lambda p, h: h @ p["w"], stack_stage_params([{"w": w}] * 2),
              xs, group=None, ranks=[0])
    with pytest.raises(ValueError, match="preserve activation shape"):
        gpipe(lambda p, h: h[:, :2], stack_stage_params([{"w": w}]), xs,
              group=None, ranks=[0])
    w1 = (torch.eye(4) * 0.5).requires_grad_(True)
    y = gpipe(lambda p, h: torch.tanh(h @ p["w"]), {"w": w1[None]}, xs,
              group=None, ranks=[0])
    assert torch.allclose(y, torch.tanh(xs @ (torch.eye(4) * 0.5)))
    y.sum().backward()
    assert w1.grad is not None and float(w1.grad.abs().sum()) > 0


def test_sp_gather_free_needs_sequence_parallel(tmp_path, tiny_config):
    """``--sp-gather-free`` without ``--sequence-parallel`` (nor
    ``sequence_parallel_train`` in the config) exits with the JAX CLI's
    message, before any process starts."""
    from mmqg_tpu_torch import train as T

    path = tiny_config.save(tmp_path / "config.json")
    with pytest.raises(SystemExit, match="--sp-gather-free requires "
                       r"--sequence-parallel \(it selects HOW"):
        T.main(["-c", str(path), "--sp-gather-free", "--device", "cpu"])


def test_mesh_shape_must_lay_out_the_processes(tiny_config):
    """A ``mesh_shape`` other than (1, 1) must hold exactly the processes,
    as the JAX CLI's make_mesh requires of its devices."""
    from mmqg_tpu_torch import train as T

    T._check_mesh(tiny_config.replace(mesh_shape=(1, 2)), 2)
    T._check_mesh(tiny_config, 3)
    with pytest.raises(SystemExit, match=r"mesh shape \(2, 2\) != 2"):
        T._check_mesh(tiny_config.replace(mesh_shape=(2, 2)), 2)


def test_chip_smoke_drives_the_model_axis_phase():
    """``chip_smoke.main`` runs phase 20 and lists its launches for every
    kernel of the summary line."""
    import inspect

    import chip_smoke

    src = inspect.getsource(chip_smoke.main)
    assert 'phase_model_axis(dev["card"], model)' in src
    assert src.count('"launches_model_axis": on_axis(') == 7
