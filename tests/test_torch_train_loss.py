"""The port's training objective vs the JAX package: ``loss_fn`` and its
gradients (through K4's plain versions, the masked-BN train statistics, the
differentiable attention and the teacher-forced decoder), the layers'
train-mode pieces, and dropout's statistics.

Parity contract, f32, dropout 0, ``train=True``: the objective and
``loss_per_token`` within 1e-5 relative, every gradient leaf within 1e-4
relative (max |d| over max |reference| of the leaf), the new batchnorm
running statistics within 1e-4 relative (sums over ~10^4 values per
channel, see below) and their counts equal. A leaf whose
gradient is zero analytically is f32 noise on both sides (the tiny corpus's
audio is one sine, so every audio example embeds alike and the audio
attention's scores get no gradient: ~3e-8): such a leaf is held to 1e-7
absolute instead.

The video tower's gradients are sensitive to how the masked batchnorm
statistics (sums over ~10^4 values per channel) are rounded. The JAX
package's f32 statistics can sit far from the exact ones: with model seed
8 its video gradients are 2.6e-3 (of a leaf's max) away from those of the
same JAX function with the statistics in f64, while the port's f32
gradients are within 4.5e-6 of those at seeds 6, 7, 8 and 11. So the port
is held to the JAX package as it is at seed 6 (worst video leaf 2.5e-5),
and at several seeds to the JAX package with f64 video-encoder statistics,
both at 1e-4.

JAX's dropout streams (threefry) are not reproduced: dropout is held to its
distribution instead."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmqg_tpu.data.dataset import QGDataset
from mmqg_tpu.models import layers as JL
from mmqg_tpu.models import qg_model as JQ
from mmqg_tpu.models import video_encoder as JVE
from mmqg_tpu.ops import attention as JA
from mmqg_tpu_torch.compat.from_jax import params_from_numpy
from mmqg_tpu_torch.models import layers as L
from mmqg_tpu_torch.models import qg_model as TQ
from mmqg_tpu_torch.ops.attention import trimodal_attention_xla
from mmqg_tpu_torch.optim import tree_leaves
from mmqg_tpu_torch.train import batch_arrays, to_device
from tests.torch_port_fixtures import tiny_model

torch.set_num_threads(1)
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
NOISE_ATOL = 1e-7   # analytically-zero leaves (see the module docstring)


@pytest.fixture(scope="module")
def setup(tiny_config, tiny_corpus):
    ds = QGDataset(tiny_config, tiny_config.train_file)
    mc, params, state = tiny_model(tiny_config, n_vocab=len(ds.vocab), seed=6)
    mc = mc._replace(dropout=0.0, text_dropout=0.0)
    batch = batch_arrays(next(ds.batches(4)))
    return mc, params, state, batch


class _F64VideoNumpy:
    """``jax.numpy`` as the JAX video encoder sees it when its float32 maths
    (the masked batchnorm statistics and normalisation, conv1's folded
    input normalisation) runs in float64."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _jax_loss_and_grads(mc, params, state, batch, **caps):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def f(p):
        return JQ.loss_fn(p, state, mc, jb, train=True, dtype=jnp.float32,
                          **caps)

    (obj, aux), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    grads = jax.tree.map(np.asarray, grads)
    grads["decoder"]["attn"] = grads["decoder"]["attn"]._asdict()
    return obj, aux, grads


def _port_loss_and_grads(mc, params, state, batch, **caps):
    model = params_from_numpy(params, state, trainable=True)
    obj, aux = TQ.loss_fn(model, TQ.ModelConfig(**mc._asdict()), model_batch(
        batch), train=True, dtype=torch.float32, **caps)
    obj.backward()
    grads = TQ.param_tree(model)
    return obj, aux, grads


def model_batch(batch):
    return to_device(batch, "cpu")


def _grad_ok(got, ref):
    err = float(np.abs(got - ref).max())
    return err <= max(GRAD_RTOL * float(np.abs(ref).max()), NOISE_ATOL)


def _walk(a, b, path=""):
    if isinstance(a, dict):
        for k in a:
            yield from _walk(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _walk(x, y, f"{path}/{i}")
    else:
        yield path, a, b


@pytest.mark.parametrize("capped", [False, True])
def test_loss_and_every_gradient_match_jax(setup, capped):
    mc, params, state, batch = setup
    caps = ({"audio_cap": 1, "frames_cap": 2} if capped else {})
    j_obj, j_aux, j_grads = _jax_loss_and_grads(mc, params, state, batch,
                                                **caps)
    obj, aux, p_grads = _port_loss_and_grads(mc, params, state, batch, **caps)
    np.testing.assert_allclose(obj.item(), float(j_obj), rtol=LOSS_RTOL)
    np.testing.assert_allclose(aux["loss_per_token"].item(),
                               float(j_aux["loss_per_token"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(aux["loss_per_sample"].item(),
                               float(j_aux["loss_per_sample"]),
                               rtol=LOSS_RTOL)
    assert int(aux["n_tokens"]) == int(j_aux["n_tokens"])
    n = 0
    for path, p, ref in _walk(p_grads, j_grads):
        assert p.grad is not None, path
        assert _grad_ok(p.grad.numpy(), ref), path
        n += 1
    assert n == len(tree_leaves(p_grads)) == len(jax.tree.leaves(j_grads))
    # the new batchnorm running statistics and their counts
    j_bns = j_aux["state"]["video_enc"]["bns"]
    for got, ref in zip(aux["state"]["video_enc"]["bns"], j_bns):
        for k in ("mean", "var"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                       rtol=1e-4)
        assert float(got["count"]) == float(ref["count"]) == 1.0


@pytest.mark.parametrize("seed", [6, 7, 8])
def test_gradients_match_jax_with_f64_batchnorm_statistics(
        tiny_config, tiny_corpus, monkeypatch, seed):
    """The port as it ships (f32) against the JAX package whose video
    encoder computes its batchnorm statistics in f64: the loss within
    1e-5 and every gradient leaf within 1e-4 of its max, at model seeds
    where the JAX package's own f32 statistics are up to 2.6e-3 away."""
    ds = QGDataset(tiny_config, tiny_config.train_file)
    mc, params, state = tiny_model(tiny_config, n_vocab=len(ds.vocab),
                                   seed=seed)
    mc = mc._replace(dropout=0.0, text_dropout=0.0)
    batch = batch_arrays(next(ds.batches(4)))
    monkeypatch.setattr(JVE, "jnp", _F64VideoNumpy())
    with jax.enable_x64(True):
        j_obj, _, j_grads = _jax_loss_and_grads(mc, params, state, batch)
    obj, _, p_grads = _port_loss_and_grads(mc, params, state, batch)
    np.testing.assert_allclose(obj.item(), float(j_obj), rtol=LOSS_RTOL)
    bad = [path for path, p, ref in _walk(p_grads, j_grads)
           if not _grad_ok(p.grad.numpy(), ref)]
    assert not bad


def test_state_update_stays_out_of_the_graph(setup):
    mc, params, state, batch = setup
    model = params_from_numpy(params, state, trainable=True)
    _, aux = TQ.loss_fn(model, TQ.ModelConfig(**mc._asdict()),
                        model_batch(batch), dtype=torch.float32)
    for bn in aux["state"]["video_enc"]["bns"]:
        assert not any(v.requires_grad for v in bn.values())
    before = [bn.mean.clone() for bn in model.video_enc.bns]
    TQ.load_model_state(model, aux["state"])
    after = [bn.mean for bn in model.video_enc.bns]
    assert any(not torch.equal(a, b) for a, b in zip(after, before))
    assert all(float(bn.count) == 1.0 for bn in model.video_enc.bns)


def test_attention_xla_matches_jax_in_bf16():
    """The training attention rounds alpha to the compute dtype before the
    context products, as ``trimodal_attention_xla`` does (K2 keeps it f32):
    bf16 operands, f32 sums, so only summation order differs."""
    rng = np.random.RandomState(0)
    B, Dq, Lt, La, H = 3, 10, 7, 4, 6
    p = JA.AttnParams(*(rng.randn(*s).astype(np.float32) for s in
                        ((Dq, Lt), (Lt,), (Dq, La), (La,), (Dq, La), (La,))))
    q = rng.randn(B, Dq).astype(np.float32)
    mems = [rng.randn(B, L, H).astype(np.float32) for L in (Lt, La, La)]
    lens = [np.asarray(v, np.int32) for v in ([7, 3, 1], [4, 2, 1],
                                                [1, 4, 3])]
    ref = JA.trimodal_attention_xla(
        jax.tree.map(jnp.asarray, p), jnp.asarray(q),
        *map(jnp.asarray, mems), *map(jnp.asarray, lens), dtype=jnp.bfloat16)
    from mmqg_tpu_torch.ops.attention import TriModalAttention
    attn = TriModalAttention(*(torch.tensor(x) for x in p))
    got = trimodal_attention_xla(attn, torch.tensor(q),
                                 *map(torch.tensor, mems),
                                 *map(torch.tensor, lens),
                                 dtype=torch.bfloat16)
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5)


def test_maxpool_gradient_splits_ties_like_jax():
    """Equal maxima share the cotangent equally (reduce_max's JVP); the
    ragged edge gets none."""
    rng = np.random.RandomState(1)
    x = rng.randint(0, 3, (2, 7, 5, 3)).astype(np.float32)   # many ties
    gy = rng.randn(2, 2, 1, 3).astype(np.float32)
    _, vjp = jax.vjp(lambda a: JL.maxpool2d(a, 3), jnp.asarray(x))
    ref = np.asarray(vjp(jnp.asarray(gy))[0])
    xt = torch.tensor(x, requires_grad=True)
    y = L.maxpool2d(xt, 3)
    np.testing.assert_array_equal(y.detach().numpy(),
                                  np.asarray(JL.maxpool2d(jnp.asarray(x), 3)))
    y.backward(torch.tensor(gy))
    np.testing.assert_allclose(xt.grad.numpy(), ref, rtol=1e-6, atol=1e-7)


def test_batchnorm_train_stats_match_jax_layer():
    """Unmasked, the masked train statistics are ``layers.batchnorm
    (train=True)``'s: biased variance to normalise, unbiased into the
    running variance, count + 1."""
    rng = np.random.RandomState(2)
    x = rng.randn(5, 3, 4, 6).astype(np.float32)
    p, s = JL.batchnorm_init(6)
    s = {"mean": jnp.asarray(rng.randn(6), jnp.float32),
         "var": jnp.asarray(rng.rand(6) + 0.5, jnp.float32),
         "count": jnp.asarray(3.0)}
    ref, ref_s = JL.batchnorm(p, s, jnp.asarray(x), train=True)
    bn = L.BatchNorm(*(torch.tensor(np.asarray(v)) for v in
                       (p["scale"], p["bias"], s["mean"], s["var"],
                        s["count"])))
    y, st = bn.train_forward(torch.tensor(x), torch.ones(5, dtype=torch.bool))
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(st[k].numpy(), np.asarray(ref_s[k]),
                                   rtol=1e-6)
    assert float(st["count"]) == 4.0


# ------------------------------------------------------------------ dropout

def test_dropout_keep_rate_and_scaling():
    g = torch.Generator().manual_seed(0)
    x = torch.ones(200_000)
    y = L.dropout(x, 0.2, g)
    kept = y != 0
    # binomial: sd of the keep rate is sqrt(.8 * .2 / 2e5) ~ 9e-4
    assert abs(kept.float().mean().item() - 0.8) < 5e-3
    np.testing.assert_allclose(y[kept].numpy(), 1.0 / 0.8, rtol=1e-6)


def test_dropout_masks_differ_across_steps_and_layers(setup):
    """Text encoder: one fresh (B, T, H) mask per layer, so every (step,
    layer) pair is drawn anew; the decoder draws one per step and layer."""
    mc, params, state, batch = setup
    model = params_from_numpy(params, state)
    b = model_batch(batch)
    masks = []
    orig = L.dropout

    def spy(x, rate, generator):
        y = orig(x, rate, generator)
        masks.append(y == 0)
        return y

    L.dropout = spy
    try:
        model.text_enc(model.embedding, b["context_ids"], b["context_len"],
                       train=True, dropout=0.5,
                       generator=torch.Generator().manual_seed(1),
                       dtype=torch.float32)
    finally:
        L.dropout = orig
    assert len(masks) == mc.text_layers - 1
    m = masks[0]
    assert m.shape[1] == mc.context_max_length
    assert not all(torch.equal(m[:, 0], m[:, t]) for t in range(1, 4))


def test_dropout_same_seed_same_loss_and_backward_sees_forward_mask(setup):
    mc, params, state, batch = setup
    mc = mc._replace(dropout=0.3, text_dropout=0.3)
    tmc = TQ.ModelConfig(**mc._asdict())

    def run(seed):
        model = params_from_numpy(params, state, trainable=True)
        obj, _ = TQ.loss_fn(model, tmc, model_batch(batch),
                            generator=torch.Generator().manual_seed(seed),
                            dtype=torch.float32)
        obj.backward()
        return obj.item(), model.text_enc.lstm.layers[0].wx.grad.clone()

    l1, g1 = run(7)
    l2, g2 = run(7)
    l3, _ = run(8)
    assert l1 == l2 and torch.equal(g1, g2)
    assert l1 != l3


def test_dropout_mask_is_the_same_in_forward_and_backward():
    """The gradient through dropout is the forward's mask times the
    scale: zero exactly where the forward dropped."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(64, 32, requires_grad=True)
    y = L.dropout(x, 0.4, g)
    y.sum().backward()
    dropped = (y == 0) & (x != 0)
    assert torch.all(x.grad[dropped] == 0)
    np.testing.assert_allclose(x.grad[~dropped].numpy(), 1 / 0.6, rtol=1e-6)
