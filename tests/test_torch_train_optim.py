"""The port's optimizers and learning-rate schedules (``mmqg_tpu_torch
.optim``) vs optax as ``mmqg_tpu.train`` builds them: the same schedule
values at every step, the same state layout leaf for leaf (what a msgpack
checkpoint holds), and the same updates from the same gradients within
1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from mmqg_tpu import train as JT
from mmqg_tpu.config import Config
from mmqg_tpu_torch import optim as O
from mmqg_tpu_torch.checkpoint import _state_dict

torch.set_num_threads(1)

SCHEDULES = {
    "constant": {},
    "warmup": {"lr_warmup_steps": 3},
    "cosine": {"lr_schedule": "cosine", "lr_warmup_steps": 2,
               "lr_decay_steps": 9, "lr_min_ratio": 0.1},
    "cosine_no_warmup": {"lr_schedule": "cosine", "lr_decay_steps": 5},
    "linear": {"lr_schedule": "linear", "lr_warmup_steps": 2,
               "lr_decay_steps": 7, "lr_min_ratio": 0.2},
}
OPTIMIZERS = {
    "adam": {},
    "adam_cosine": SCHEDULES["cosine"],
    "adamw": {"weight_decay": 0.05},
    "sgd": {"optim": "sgd", "lr": 0.1},
    "sgd_warmup": {"optim": "sgd", "lr": 0.1, "lr_warmup_steps": 2},
    "clip": {"grad_clip_norm": 0.5},
    "text_non_trainable": {"text_non_trainable": True},
    "frozen_clip_adamw": {"text_non_trainable": True, "grad_clip_norm": 0.5,
                          "weight_decay": 0.05},
}


def _params(seed=0):
    """A small tree with the model's kinds of leaves: the embedding table,
    matrices, biases, lists."""
    rng = np.random.RandomState(seed)
    f = np.float32
    return {"embedding": {"table": rng.randn(5, 3).astype(f)},
            "text_enc": {"lstm": {"layers": [
                {"wx": rng.randn(3, 8).astype(f),
                 "wh": rng.randn(2, 8).astype(f), "b": rng.randn(8).astype(f)}
                for _ in range(2)]}},
            "decoder": {"out": {"w": rng.randn(2, 5).astype(f),
                                "b": rng.randn(5).astype(f)}}}


def _np(tree):
    return O.tree_map(lambda t: t.numpy(), tree)


def _torch(tree):
    return O.tree_map(lambda a: torch.tensor(np.asarray(a)), tree)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_equals_optax(name):
    cfg = Config(lr=1e-2, **SCHEDULES[name])
    ref = JT.learning_rate_schedule(cfg)
    got = O.learning_rate_schedule(cfg)
    if name == "constant":
        assert got == ref == 1e-2
        return
    for step in range(14):
        r = float(ref(jnp.asarray(step, jnp.int32)))
        g = float(got(torch.tensor(step, dtype=torch.int32)))
        assert abs(g - r) <= 1e-6 * 1e-2, (step, g, r)
    # optax's count starts at 0: the first update uses schedule(0)
    if SCHEDULES[name].get("lr_warmup_steps"):
        assert float(got(torch.tensor(0, dtype=torch.int32))) == 0.0


@pytest.mark.parametrize("kw", [
    {"lr_decay_steps": 5}, {"lr_min_ratio": 0.1},
    {"lr_schedule": "step"}, {"lr_schedule": "cosine", "lr_decay_steps": 0},
    {"lr_schedule": "linear", "lr_warmup_steps": 4, "lr_decay_steps": 4},
    {"optim": "sgd", "weight_decay": 0.1}, {"optim": "rmsprop"}])
def test_invalid_configs_raise_like_jax(kw):
    cfg = Config(**kw)
    with pytest.raises(ValueError) as ref:
        JT.make_optimizer(cfg)
    with pytest.raises(ValueError) as got:
        O.make_optimizer(cfg)
    assert str(got.value) == str(ref.value)


def _layout(tree):
    return O.tree_map(lambda a: (tuple(a.shape), str(a.dtype)), tree)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_state_layout_and_updates_match_optax(name):
    cfg = Config(**{"lr": 1e-2, **OPTIMIZERS[name]})
    params = _params()
    j_opt = JT.make_optimizer(cfg)
    j_params = jax.tree.map(jnp.asarray, params)
    j_state = j_opt.init(j_params)
    p_opt = O.make_optimizer(cfg)
    p_params = _torch(params)
    p_state = p_opt.init(p_params)

    def ref_layout():
        sd = serialization.to_state_dict(jax.tree.map(np.asarray, j_state))
        return _layout(_state_dict(sd))

    assert _layout(_state_dict(_np(p_state))) == ref_layout()
    rng = np.random.RandomState(1)
    for _ in range(4):   # bias correction, schedule counts and clipping
        grads = O.tree_map(lambda a: (rng.randn(*a.shape) * 0.7
                                      ).astype(np.float32), params)
        j_up, j_state = j_opt.update(jax.tree.map(jnp.asarray, grads),
                                     j_state, j_params)
        j_params = optax.apply_updates(j_params, j_up)
        p_up, p_state = p_opt.update(_torch(grads), p_state, p_params)
        O.apply_updates(p_params, p_up)
        for got, ref in zip(O.tree_leaves(_np(p_params)),
                            jax.tree.leaves(j_params)):
            np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-6,
                                       atol=1e-6)
    # the whole state, leaf for leaf, as a checkpoint would hold it
    sd = _state_dict(serialization.to_state_dict(
        jax.tree.map(np.asarray, j_state)))
    mine = _state_dict(_np(p_state))
    assert _layout(mine) == _layout(sd)
    for got, ref in zip(O.tree_leaves(mine), O.tree_leaves(sd)):
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    if cfg.text_non_trainable:
        np.testing.assert_array_equal(p_params["embedding"]["table"].numpy(),
                                      params["embedding"]["table"])


def test_global_norm_and_apply_updates_in_place():
    p = _torch(_params())
    table = p["embedding"]["table"]
    O.apply_updates(p, O.tree_map(torch.ones_like, p))
    assert p["embedding"]["table"] is table
    ref = float(optax.global_norm(jax.tree.map(jnp.asarray, _params())))
    assert abs(float(O.global_norm(_torch(_params()))) - ref) <= 1e-5 * ref
