"""The PyTorch port reads the JAX package's msgpack checkpoints: bit-equal
parameters, and the same f32 greedy tokens as the JAX model."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from mmqg_tpu import checkpoint as jckpt
from mmqg_tpu import decode as JDEC
from mmqg_tpu.ops.attention import AttnParams
from mmqg_tpu.train import make_optimizer
from mmqg_tpu_torch import checkpoint as ckpt
from mmqg_tpu_torch import decode as DEC
from mmqg_tpu_torch.compat.from_jax import params_from_numpy
from mmqg_tpu_torch.pipeline import QGPipeline
from tests.torch_port_fixtures import tiny_batch, tiny_model, torch_batch

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def saved(tiny_config, tmp_path_factory):
    root = tmp_path_factory.mktemp("port_ckpt")
    cfg = tiny_config.replace(output_path=root / "results",
                              data_path=root / "data").ensure_dirs()
    mc, params, state = tiny_model(cfg, n_vocab=30, seed=6)
    words = ["<pad>", "<start>", "<end>"] + [f"w{i}" for i in range(3, 30)]
    with open(cfg.vocab_file, "w") as f:
        json.dump({w: i for i, w in enumerate(words)}, f)
    with open(cfg.index_to_word_file, "w") as f:
        json.dump({str(i): w for i, w in enumerate(words)}, f)
    jparams = jax.tree.map(jnp.asarray, params)
    train_state = {"params": jparams,
                   "model_state": jax.tree.map(jnp.asarray, state),
                   "opt_state": make_optimizer(cfg).init(jparams),
                   "step": jnp.asarray(7, jnp.int32)}
    jckpt.save_checkpoint(cfg.checkpoint_dir, "best", train_state)
    return cfg, mc, params, state, train_state


def test_from_checkpoint_is_bit_equal(saved):
    cfg, mc, params, state, _ = saved
    pipe = QGPipeline.from_checkpoint(cfg, alias="best", dtype=torch.float32)
    assert pipe.mc._asdict() == mc._asdict()
    direct = params_from_numpy(params, state).state_dict()
    loaded = pipe.model.state_dict()
    assert loaded.keys() == direct.keys()
    for k in direct:
        assert loaded[k].dtype == torch.float32
        assert torch.equal(loaded[k], direct[k]), k
    np.testing.assert_array_equal(pipe.model.decoder.attn.w_audio.numpy(),
                                  params["decoder"]["attn"].w_audio)
    np.testing.assert_array_equal(
        pipe.model.video_enc.bns[2].var.numpy(),
        state["video_enc"]["bns"][2]["var"])


def test_checkpoint_greedy_tokens_match_jax_f32(saved):
    cfg, mc, _, _, train_state = saved
    restored, _ = jckpt.load_checkpoint(cfg.checkpoint_dir, "best",
                                        train_state)
    b = tiny_batch(mc, B=4, seed=9)
    ref = np.asarray(JDEC.decode_batch(
        restored["params"], restored["model_state"], mc,
        {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(0),
        max_len=mc.target_steps - 1, use_pallas=False, dtype=jnp.float32))
    pipe = QGPipeline.from_checkpoint(cfg, dtype=torch.float32)
    got = DEC.decode_batch(pipe.model, pipe.mc, torch_batch(b),
                           max_len=mc.target_steps - 1, dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_reader_undoes_lists_namedtuples_chunks_and_bf16(monkeypatch,
                                                         tmp_path):
    rng = np.random.RandomState(0)
    tree = {"layers": [{"w": rng.randn(3, 2).astype(np.float32)},
                       {"w": rng.randn(2).astype(np.float32)}],
            "attn": AttnParams(*(np.full((2,), i, np.float32)
                                 for i in range(6))),
            "pair": (np.int32(4), np.arange(5, dtype=np.int64)),
            "half": jnp.asarray([1.5, -2.25, 3e-3], jnp.bfloat16),
            "big": rng.randn(40).astype(np.float32)}
    # chunk everything above 64 bytes, as flax does above 2**30
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    blob = serialization.msgpack_serialize(serialization.to_state_dict(tree))
    out = ckpt.msgpack_restore(blob)
    np.testing.assert_array_equal(out["layers"][0]["w"], tree["layers"][0]["w"])
    np.testing.assert_array_equal(out["layers"][1]["w"], tree["layers"][1]["w"])
    assert sorted(out["attn"]) == sorted(AttnParams._fields)
    np.testing.assert_array_equal(out["attn"]["b_audio"], 5.0)
    assert out["pair"][0] == 4 and out["pair"][1].tolist() == list(range(5))
    np.testing.assert_array_equal(
        out["half"], np.asarray(tree["half"].astype(jnp.float32)))
    np.testing.assert_array_equal(out["big"], tree["big"])
    with pytest.raises(FileNotFoundError):
        ckpt.load_checkpoint(tmp_path, "missing")
