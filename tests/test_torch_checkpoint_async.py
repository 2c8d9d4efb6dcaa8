"""Asynchronous checkpoints and the orbax backend of the port
(``mmqg_tpu_torch.checkpoint``) against the JAX package's
``mmqg_tpu.checkpoint``.

The state is the tiny text_video model's train state with AdamW's chain,
masked state and the ``text_non_trainable`` freeze (empty masked-out
nodes), its moments random. Asynchronous saves publish the synchronous
bytes and keep the order of saves and copies; a writer's error comes back
from ``wait_for_pending``; with a process group (two gloo ranks) the
other rank reads a file the primary's writer is still writing only after
``wait_for_pending(group)``. The port's ``<alias>.orbax/`` restores in
the JAX package's loader exactly and the JAX package's restores in the
port's exactly; a save under one backend drops the other's artifact;
without ``tensorstore`` the orbax backend raises ImportError and writes
nothing.
"""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from mmqg_tpu_torch import checkpoint as ckpt

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
CHILD_TIMEOUT = 120
SLOW_WRITE_S = 1.0


def _flat(tree, prefix=""):
    """{path: leaf} of a state dict or of the port's tree (lists keyed by
    index, as flax's state dict keys them)."""
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        tree = {str(i): v for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out if tree else {prefix.rstrip("/"): "{}"}
    return {prefix.rstrip("/"): tree}


def _state_dict(tree):
    """The port's tree in flax's state-dict form (lists keyed by index)."""
    if isinstance(tree, (list, tuple)):
        tree = {str(i): v for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        return {k: _state_dict(v) for k, v in tree.items()}
    return tree


def _assert_same(got, ref):
    g, r = _flat(got), _flat(ref)
    assert set(g) == set(r)
    for k in r:
        if isinstance(r[k], str):
            assert g[k] == r[k], k
            continue
        a, b = np.asarray(g[k]), np.asarray(r[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k


@pytest.fixture(scope="module")
def states(tiny_config):
    """(the port's host train state, the JAX package's template of the
    same structure, the config)."""
    import jax
    from flax import serialization

    from mmqg_tpu import train as JT
    from mmqg_tpu_torch.optim import tree_map
    from tests.torch_port_fixtures import tiny_model

    cfg = tiny_config.replace(weight_decay=1e-2, grad_clip_norm=1.0,
                              text_non_trainable=True)
    _, params, model_state = tiny_model(cfg, n_vocab=41, seed=3)
    params.pop("audio_enc")
    template = {"params": params, "model_state": model_state,
                "opt_state": JT.make_optimizer(cfg).init(params),
                "step": np.zeros((), np.int32)}
    template = jax.tree.map(np.asarray, template)
    rng = np.random.default_rng(0)
    host = ckpt.msgpack_restore(ckpt.msgpack_serialize(
        serialization.to_state_dict(template)))
    host = tree_map(lambda a: (rng.standard_normal(a.shape).astype(a.dtype)
                               if a.dtype == np.float32 else a), host)
    host["step"] = np.asarray(7, np.int32)
    return host, template, cfg


def _bump(host, by: float):
    from mmqg_tpu_torch.optim import tree_map

    return tree_map(lambda a: a + np.float32(by) if a.dtype == np.float32
                    else a, host)


@pytest.mark.parametrize("backend", ["msgpack", "orbax"])
def test_async_save_publishes_the_sync_bytes(states, tmp_path, backend):
    host, _, _ = states
    meta = {"epoch": 2, "best_val": 1.25}
    ckpt.save_checkpoint(tmp_path, "sync", host, meta, backend=backend)
    path = ckpt.save_checkpoint(tmp_path, "async", host, meta,
                                backend=backend, async_save=True)
    ckpt.wait_for_pending()
    assert path.exists()
    assert ckpt.load_metadata(tmp_path, "async") == meta
    if backend == "msgpack":
        assert path.read_bytes() == (tmp_path / "sync.msgpack").read_bytes()
    else:
        assert sorted(os.listdir(path)) == sorted(os.listdir(
            tmp_path / "sync.orbax"))
        _assert_same(ckpt.load_checkpoint(tmp_path, "async"),
                     ckpt.load_checkpoint(tmp_path, "sync"))
    _assert_same(ckpt.load_checkpoint(tmp_path, "async"), host)


def test_async_saves_and_copies_keep_their_order(states, tmp_path):
    """Five asynchronous saves of ``last``, each followed by an
    asynchronous copy to its own ``best<i>`` and to ``best``: every copy
    holds the save queued before it, ``best`` the last one."""
    host, _, _ = states
    want = {}
    for i in range(5):
        state = _bump(host, i)
        ckpt.save_checkpoint(tmp_path, "last", state, {"epoch": i},
                             async_save=True)
        ckpt.copy_checkpoint(tmp_path, "last", f"best{i}", async_copy=True)
        ckpt.copy_checkpoint(tmp_path, "last", "best", async_copy=True)
        want[f"best{i}"] = ckpt.msgpack_serialize(state)
    ckpt.wait_for_pending()
    for alias, blob in want.items():
        assert (tmp_path / f"{alias}.msgpack").read_bytes() == blob, alias
        assert ckpt.load_metadata(tmp_path, alias)["epoch"] == int(alias[-1])
    assert (tmp_path / "best.msgpack").read_bytes() == want["best4"]
    assert not list(tmp_path.glob("*.tmp"))


def test_writer_error_comes_back_from_wait_for_pending(states, tmp_path):
    """A write that fails on the writer thread (its directory is a file)
    raises from wait_for_pending, once; later writes still land."""
    host, _, _ = states
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("")
    ckpt.save_checkpoint(blocker, "last", host, async_save=True)
    ckpt.save_checkpoint(tmp_path, "after", host, async_save=True)
    with pytest.raises(OSError):
        ckpt.wait_for_pending()
    ckpt.wait_for_pending()
    assert ckpt.has_checkpoint(tmp_path, "after")


def test_orbax_written_by_the_port_restores_in_jax_exactly(states, tmp_path):
    from flax import serialization

    from mmqg_tpu import checkpoint as JC

    host, template, _ = states
    ckpt.save_checkpoint(tmp_path, "best", host, {"epoch": 3},
                         backend="orbax")
    assert sorted(p.name for p in (tmp_path / "best.orbax").iterdir()) == [
        "_CHECKPOINT_METADATA", "_METADATA", "d", "manifest.ocdbt",
        "ocdbt.process_0"]
    restored, meta = JC.load_checkpoint(tmp_path, "best", template)
    assert meta == {"epoch": 3}
    _assert_same(serialization.to_state_dict(restored), host)


def test_orbax_written_by_jax_restores_in_the_port_exactly(states,
                                                           tmp_path):
    from flax import serialization

    from mmqg_tpu import checkpoint as JC

    host, template, _ = states
    jax_state = serialization.from_state_dict(template, _state_dict(host))
    JC.save_checkpoint(tmp_path, "last", jax_state, {"epoch": 5},
                       backend="orbax")
    assert ckpt.has_checkpoint(tmp_path, "last")
    _assert_same(ckpt.load_checkpoint(tmp_path, "last"), host)
    # a copy under the orbax backend is the same checkpoint
    ckpt.copy_checkpoint(tmp_path, "last", "best", backend="orbax")
    _assert_same(ckpt.load_checkpoint(tmp_path, "best"), host)
    assert ckpt.load_metadata(tmp_path, "best") == {"epoch": 5}


def test_backend_switch_drops_stale_artifact(states, tmp_path):
    """As the JAX package's ``test_backend_switch_drops_stale_artifact``:
    a save under one backend removes the alias's other artifact (load
    prefers msgpack), both ways, and so does a copy."""
    host, _, _ = states
    s2 = _bump(host, 7.0)
    ckpt.save_checkpoint(tmp_path, "last", host, {"epoch": 4})
    ckpt.save_checkpoint(tmp_path, "last", s2, {"epoch": 9},
                         backend="orbax")
    assert not (tmp_path / "last.msgpack").exists()
    _assert_same(ckpt.load_checkpoint(tmp_path, "last"), s2)
    assert ckpt.load_metadata(tmp_path, "last")["epoch"] == 9
    ckpt.save_checkpoint(tmp_path, "last", host, async_save=True)
    ckpt.wait_for_pending()
    assert not (tmp_path / "last.orbax").exists()
    ckpt.save_checkpoint(tmp_path, "best", s2, backend="orbax")
    ckpt.copy_checkpoint(tmp_path, "last", "best")
    assert not (tmp_path / "best.orbax").exists()
    _assert_same(ckpt.load_checkpoint(tmp_path, "best"), host)
    with pytest.raises(ValueError, match="unknown checkpoint backend"):
        ckpt.save_checkpoint(tmp_path, "x", host, backend="pickle")


def test_orbax_without_tensorstore_raises_and_writes_nothing(
        states, tmp_path, monkeypatch):
    host, _, _ = states
    ckpt.save_checkpoint(tmp_path, "old", host, backend="orbax")
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    for kw in ({}, {"async_save": True}):
        with pytest.raises(ImportError, match="tensorstore"):
            ckpt.save_checkpoint(tmp_path, "last", host, backend="orbax",
                                 **kw)
    ckpt.wait_for_pending()
    assert not ckpt.has_checkpoint(tmp_path, "last")
    assert not list(tmp_path.glob("last*"))
    with pytest.raises(ImportError, match="tensorstore"):
        ckpt.load_checkpoint(tmp_path, "old")


def test_trainer_async_orbax_checkpoints_resume(tiny_config, tiny_corpus,
                                                tmp_path):
    """A Trainer with ``checkpoint_async`` and the orbax backend (mode
    text): fit returns with ``last`` and ``best`` published, and a fresh
    Trainer resumes every leaf of them."""
    from mmqg_tpu_torch.compat.from_jax import train_state_to_numpy
    from mmqg_tpu_torch.config import Config
    from mmqg_tpu_torch.data.dataset import QGDataset
    from mmqg_tpu_torch.models import qg_model as TQ
    from mmqg_tpu_torch.train import Trainer

    cfg = Config.load(tiny_config.save(tmp_path / "c.json")).replace(
        output_path=tmp_path / "out", checkpoint_async=True,
        checkpoint_backend="orbax")
    cfg.ensure_dirs()
    train_ds = QGDataset(cfg, cfg.train_file, load_media=False)
    val_ds = QGDataset(cfg, cfg.val_file, load_media=False)
    mc = TQ.ModelConfig.from_config(cfg, n_vocab=len(train_ds.vocab),
                                    mode="text")
    emb = np.load(cfg.weights_matrix_file).astype(np.float32)

    def trainer():
        return Trainer(cfg, mc, emb, train_ds, val_ds, device="cpu",
                       log_fn=lambda *a, **k: None)
    tr = trainer()
    tr.fit(1)
    for alias in ("last", "best"):
        assert (cfg.checkpoint_dir / f"{alias}.orbax").is_dir()
        assert not (cfg.checkpoint_dir / f"{alias}.msgpack").exists()
    fresh = trainer()
    assert fresh.resume("best") and fresh.start_epoch == 1
    ts = fresh.train_state
    _assert_same(train_state_to_numpy(ts.model, ts.opt_state, ts.step),
                 ckpt.load_checkpoint(cfg.checkpoint_dir, "last"))


# ----------------------------------------------- a process group, two ranks

def _group_child(rank: str, port: str, data_dir: str) -> None:
    """Rank 0 queues an asynchronous save whose write takes SLOW_WRITE_S;
    rank 1 reads the file after ``wait_for_pending(group)``."""
    import torch.distributed as dist

    from mmqg_tpu_torch.parallel import multihost as MH

    torch.set_num_threads(1)
    rank, d = int(rank), Path(data_dir)
    MH.initialize_multihost(f"localhost:{port}", 2, rank, device="cpu",
                            timeout_s=CHILD_TIMEOUT)
    state = {"w": np.arange(6, dtype=np.float32), "step": np.int32(3)}
    write = ckpt._write_checkpoint

    def slow(*args):
        time.sleep(SLOW_WRITE_S)
        write(*args)
    ckpt._write_checkpoint = slow
    t0 = time.perf_counter()
    ckpt.save_checkpoint(d, "last", state if rank == 0 else None,
                         async_save=True, group=dist.group.WORLD)
    queued = time.perf_counter() - t0
    seen_before = ckpt.has_checkpoint(d, "last")
    ckpt.wait_for_pending(dist.group.WORLD)
    got = ckpt.load_checkpoint(d, "last")
    (d / f"rank{rank}.json").write_text(json.dumps({
        "queued_s": queued, "seen_before_wait": seen_before,
        "read": got["w"].tolist(), "waited_s": time.perf_counter() - t0}))
    dist.destroy_process_group()


def test_async_save_with_a_group_is_read_only_after_the_wait(tmp_path):
    """Two gloo ranks: the save returns on both before the primary's
    writer has written (the barrier only says it is queued); after
    ``wait_for_pending(group)`` -- the primary drains its writer, then
    the barrier -- the other rank reads the published file."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import sys; from tests.test_torch_checkpoint"
         "_async import _group_child; _group_child(*sys.argv[1:])", str(r),
         str(port), str(tmp_path)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=CHILD_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    for r in range(2):
        got = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert got["read"] == list(range(6))
        assert got["queued_s"] < SLOW_WRITE_S
        assert not got["seen_before_wait"]
        assert got["waited_s"] >= SLOW_WRITE_S
