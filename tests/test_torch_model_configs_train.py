"""Every configuration of the model in training, against the JAX package:
the objective, its gradients and the new batchnorm state, and
``remat_video`` (checkpoints and serving: ``test_torch_model_configs_io.py``).

The tiny models and batch of ``test_torch_model_configs.py`` (the decoder
as initialised, not peaked: a peaked decoder saturates the attention
softmaxes, whose gradients then cancel to f32 noise), tone audio, f32 on
the CPU, dropout 0, ``train=True``:

* the objective and ``loss_per_token`` within 1e-5 relative;
* every gradient leaf within 1e-4 of the leaf's max |reference| (a leaf
  whose gradient is zero analytically, e.g. the attention over a length-1
  zero memory, is f32 noise on both sides and is held to 1e-7 absolute);
* the new batchnorm states within 1e-4 relative (conv pyramid) and their
  counts equal.

The conv pyramid's gradients are sensitive to how its masked batchnorm
statistics (sums over ~10^4 values a channel) are rounded, and the JAX
package's f32 statistics can sit far from the exact ones
(``test_torch_train_loss.py``): for the conv-LSTM configurations the JAX
side computes them in float64 (``jax_video_stats_f64``), the port runs as
it ships.

R(2+1)D in train mode is ill-conditioned at these sizes (8-32 positions a
channel in stage 4): both packages' f32 towers are up to 1e-3 of the
memory's max from the exact result, and their trunk gradients up to ~0.3
of a leaf's max (``test_torch_video_resnet.py`` holds the tower itself,
in f32 and in float64). So for the resnet configurations both packages
run the video tower in float64 here (``jax_resnet_f64``,
``port_resnet_f64``; the rest of the model in f32): every leaf outside the
trunk is then held to 1e-4 as above, and the trunk's leaves, whose
backward still amplifies the f32 differences of the cotangent the decoder
hands it, to a band of TRUNK_BAND of the leaf's max."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmqg_tpu.models import qg_model as JQ
from mmqg_tpu_torch.compat.from_jax import params_from_numpy
from mmqg_tpu_torch.models import qg_model as TQ
from mmqg_tpu_torch.optim import make_optimizer, tree_leaves
from mmqg_tpu_torch.train import TrainState, make_train_step, to_device
from tests.test_torch_model_configs import (CONFIGS, IDS, build, caps_of,
                                            jax_params)
from tests.torch_port_fixtures import (jax_resnet_f64, jax_video_stats_f64,
                                       port_resnet_f64, tiny_batch, walk)

torch.set_num_threads(1)
LOSS_RTOL, GRAD_RTOL, NOISE_ATOL = 1e-5, 1e-4, 1e-7
TRUNK_BAND = 0.5
TRUNK = ("/video_enc/stem", "/video_enc/stages/")


def tones(rng, n: int, sr: int, example: int) -> np.ndarray:
    """int16 PCM: a tone whose pitch and loudness change every example,
    over quiet noise, so that the VGGish examples differ and the audio
    attention's gradients stand above f32 noise (white noise alone embeds
    every example alike, and those gradients are near-cancelling sums)."""
    idx = np.arange(n) // example
    k = int(idx[-1]) + 1
    freq = rng.uniform(0.03, 0.45, k)[idx] * sr
    amp = rng.uniform(1000.0, 12000.0, k)[idx]
    x = amp * np.sin(2 * np.pi * freq * np.arange(n) / sr) + rng.randn(n) * 300
    return np.clip(x, -32768, 32767).astype(np.int16)


def train_batch(mc, seed=5):
    b = tiny_batch(mc, B=4, seed=seed)
    rng = np.random.RandomState(seed + 1)
    example = mc.mel_frames * mc.stft_hop
    b["audio_pcm"] = np.stack([tones(rng, b["audio_pcm"].shape[1],
                                     mc.sample_rate, example)
                               for _ in range(4)])
    b["target_ids"] = rng.randint(3, mc.n_vocab, (4, mc.target_steps)
                                  ).astype(np.int32)
    b["target_len"] = np.asarray([mc.target_steps, 3, 5, 1], np.int32)
    b["valid"] = np.asarray([True, True, True, False])
    return b


def _towers(mc):
    """(JAX context, port context) of the video tower's precision."""
    if mc.mode == "text":
        return contextlib.nullcontext(), contextlib.nullcontext()
    if mc.video_encoder == "resnet":
        return jax_resnet_f64(force=True), port_resnet_f64()
    return jax_video_stats_f64(), contextlib.nullcontext()


@pytest.fixture(scope="module", params=CONFIGS, ids=IDS)
def graded(request):
    mc, tmc, params, state = build(*request.param, peak=False)
    b = train_batch(mc)
    caps = {k: v for k, v in caps_of(mc, b).items() if v is not None}
    jax_tower, port_tower = _towers(mc)
    with jax_tower:
        def f(p):
            return JQ.loss_fn(p, jax.tree.map(jnp.asarray, state), mc,
                              {k: jnp.asarray(v) for k, v in b.items()},
                              train=True, dtype=jnp.float32, **caps)
        (obj, aux), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
            jax.tree.map(jnp.asarray, jax_params(params)))
    grads = jax.tree.map(np.asarray, grads)
    if "attn" in grads["decoder"]:
        grads["decoder"]["attn"] = grads["decoder"]["attn"]._asdict()
    model = params_from_numpy(params, state, trainable=True)
    with port_tower:
        pobj, paux = TQ.loss_fn(model, tmc, to_device(b, "cpu"), train=True,
                                dtype=torch.float32, **caps)
    pobj.backward()
    return dict(mc=mc, obj=obj, aux=aux, grads=grads, pobj=pobj, paux=paux,
                pgrads=TQ.param_tree(model))


def test_loss_and_every_gradient_match_jax(graded):
    g = graded
    np.testing.assert_allclose(g["pobj"].item(), float(g["obj"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(g["paux"]["loss_per_token"].item(),
                               float(g["aux"]["loss_per_token"]),
                               rtol=LOSS_RTOL)
    assert int(g["paux"]["n_tokens"]) == int(g["aux"]["n_tokens"])
    n, bad = 0, []
    for path, p, ref in walk(g["pgrads"], g["grads"]):
        assert p.grad is not None, path
        err = float(np.abs(p.grad.numpy() - ref).max())
        rel = TRUNK_BAND if path.startswith(TRUNK) else GRAD_RTOL
        if err > max(rel * float(np.abs(ref).max()), NOISE_ATOL):
            bad.append((path, err, float(np.abs(ref).max())))
        n += 1
    assert not bad, "\n".join(f"{p} {e:.3e} of {m:.3e}" for p, e, m in bad)
    assert n == len(tree_leaves(g["pgrads"])) == len(jax.tree.leaves(
        g["grads"]))


def test_new_batchnorm_state_matches_jax(graded):
    mc, got, ref = graded["mc"], graded["paux"]["state"], \
        graded["aux"]["state"]
    assert set(got) == set(ref) == ({"video_enc"} if mc.mode != "text"
                                    else set())
    for path, a, b in walk(got, jax.tree.map(np.asarray, ref)):
        if path.endswith("count"):
            assert float(a) == float(b) == 1.0, path
        else:
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-6,
                                       err_msg=path)
        assert not a.requires_grad


@pytest.mark.parametrize("video_encoder", ["conv_lstm", "resnet"])
def test_remat_video_changes_memory_not_math(tiny_config, video_encoder):
    """``remat_video`` (the video tower under torch.utils.checkpoint): the
    same objective, gradients and new batchnorm state as without it, and
    one train step advances the running statistics once."""
    mc, tmc, params, state = build("text_video", "attn", video_encoder)
    b = to_device(train_batch(mc), "cpu")
    out = {}
    for remat in (False, True):
        model = params_from_numpy(params, state, trainable=True)
        obj, aux = TQ.loss_fn(model, tmc._replace(remat_video=remat), b,
                              train=True, dtype=torch.float32)
        obj.backward()
        out[remat] = (obj, [p.grad for p in tree_leaves(
            TQ.param_tree(model))], tree_leaves(aux["state"]))
    assert torch.equal(out[False][0], out[True][0])
    for a, b_ in zip(out[False][1], out[True][1]):
        assert torch.equal(a, b_)
    for a, b_ in zip(out[False][2], out[True][2]):
        assert torch.equal(a, b_)
    # one SGD step with remat: the buffers take the first run's state, once
    cfg = tiny_config.replace(optim="sgd", lr=0.1)
    model = params_from_numpy(params, state, trainable=True)
    opt = make_optimizer(cfg)
    ts = TrainState(model, opt.init(TQ.param_tree(model)))
    make_train_step(tmc._replace(remat_video=True), opt,
                    dtype=torch.float32)(ts, b, None)
    after = tree_leaves(TQ.model_state(model))
    for a, b_ in zip(after, out[True][2]):
        assert torch.equal(a, b_)
    counts = [float(x) for path, x, _ in walk(TQ.model_state(model),
                                                TQ.model_state(model))
              if path.endswith("count")]
    assert counts and all(c == 1.0 for c in counts)
