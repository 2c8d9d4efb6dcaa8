"""K3 and the int8 VGGish tower of the PyTorch port vs the JAX package, on
the CPU, where the port's kernel wrappers run their plain versions.

The JAX K3 (``vggish_features_pallas``) hard-codes the full VGGish shapes,
so these tests run the full conv stack (96 x 64 mel, 64..512 channels) on
three examples -- three, so the TPU kernel pads to its 8-example tile --
with a narrow fc head (12288 -> 32 -> 32 -> 16), which neither package's
functions fix. The conv weights are He-scaled so that six ReLU convs keep
the signal (with the default init it shrinks ~6^6-fold and the fc biases
swamp it). The JAX side runs K3 in interpret mode, once per dtype.

Tolerances, each relative to the reference's max |value|:
* K3 features f32: 1e-4 (the same f32 sums in another order).
* K3 features bf16: 2e-2. Both round every activation to bf16 after an f32
  sum taken in another order, so a sum that lands near a rounding boundary
  flips by one bf16 ulp (2^-8 relative) and later layers carry the flip.
* int8 embeddings f32, dynamic scales: 3e-2 (measured 1.1e-2). conv1 runs
  through two f32 conv libraries that differ in the last bit, so an
  example's scale max(x) / 127 differs in its last bit too, and a quantized
  activation whose quotient x / sx sits near a half moves by one step; the
  next layer's scale then differs more, and the flips grow layer by layer
  (2 of 294912 activations at conv2, 3841 of 147456 at conv6 here). Static
  scales are the same numbers in both packages, so only a conv1 value near
  a half can flip: 2e-3, a few flips' worth (measured 7.9e-7, none). Fed
  the same conv1 output, the two int8 stacks agree exactly.
* int8 sums, one layer's epilogue and the conv2..conv6 stack from one
  conv1 output: exact (integer sums; the same f32 operations in the same
  order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmqg_tpu.models import audio_encoder as JAE
from mmqg_tpu.ops.vggish_pallas import (embed_examples_pallas,
                                        vggish_features_pallas)
from mmqg_tpu.pipeline import QGPipeline as JaxPipeline
from mmqg_tpu_torch.compat.from_jax import params_from_numpy
from mmqg_tpu_torch.models import layers as L
from mmqg_tpu_torch.models import qg_model as TQ
from mmqg_tpu_torch.models.audio_encoder import BLOCKS, AudioEncoder
from mmqg_tpu_torch.ops import vggish as V
from mmqg_tpu_torch.pipeline import QGPipeline
from tests.torch_port_fixtures import tiny_batch, tiny_model, torch_batch

torch.set_num_threads(1)
K3_RTOL = {"float32": 1e-4, "bfloat16": 2e-2}
INT8_RTOL = {False: 3e-2, True: 2e-3}   # by static scales
N_EX = 3


def _audio_params(seed=0, fc=(32, 32, 16)):
    """Full-width VGGish convs (He-scaled uniform) and a narrow fc head, as
    the JAX pytree with numpy leaves."""
    rng = np.random.RandomState(seed)
    convs, c_in = [], 1
    for c_out, reps in BLOCKS:
        for _ in range(reps):
            lim = np.sqrt(6.0 / (9 * c_in))
            convs.append({
                "w": rng.uniform(-lim, lim, (3, 3, c_in, c_out)).astype(
                    np.float32),
                "b": rng.uniform(-0.05, 0.05, c_out).astype(np.float32)})
            c_in = c_out
    dims = (6 * 4 * 512,) + fc
    dense = [{"w": (rng.randn(i, o) / np.sqrt(i)).astype(np.float32),
              "b": (rng.randn(o) * 0.1).astype(np.float32)}
             for i, o in zip(dims[:-1], dims[1:])]
    return {"convs": convs, "fc1": dense[0], "fc2": dense[1], "fc3": dense[2]}


def _port_encoder(p) -> AudioEncoder:
    t = torch.from_numpy
    return AudioEncoder([L.Conv2d(t(c["w"]), t(c["b"])) for c in p["convs"]],
                        *(L.Dense(t(p[k]["w"]), t(p[k]["b"]))
                          for k in ("fc1", "fc2", "fc3")))


def _jax(p):
    return jax.tree.map(jnp.asarray, p)


@pytest.fixture(scope="module")
def vggish():
    p = _audio_params()
    mel = (np.random.RandomState(1).randn(N_EX, 96, 64) * 2.0).astype(
        np.float32)
    return p, _jax(p), _port_encoder(p), mel


_JAX_FEATURES = {}


def _jax_features(vggish, dtype):
    """JAX K3 in interpret mode, run once per dtype for the module."""
    if dtype not in _JAX_FEATURES:
        _, jp, _, mel = vggish
        _JAX_FEATURES[dtype] = np.asarray(vggish_features_pallas(
            jp, jnp.asarray(mel), dtype=getattr(jnp, dtype),
            interpret=True), np.float32)
    return _JAX_FEATURES[dtype]


def _rel(got, ref):
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max()
                 / np.abs(np.asarray(ref)).max())


# ---------------------------------------------------------------------- K3

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vggish_features_plain_matches_pallas_interpret(vggish, dtype):
    _, _, enc, mel = vggish
    ref = _jax_features(vggish, dtype)
    got = V.vggish_features_plain(enc.convs, torch.from_numpy(mel),
                                  dtype=getattr(torch, dtype))
    assert got.dtype == torch.float32 and got.shape == (N_EX, 12288)
    assert np.abs(ref).max() > 1.0     # the He-scaled stack keeps its signal
    assert _rel(got.numpy(), ref) <= K3_RTOL[dtype]
    # the CPU wrapper is the plain version, and counts no launch
    before = V.vggish_conv.launches
    np.testing.assert_array_equal(
        V.vggish_features(enc.convs, torch.from_numpy(mel),
                          dtype=getattr(torch, dtype)).numpy(), got.numpy())
    assert V.vggish_conv.launches == before


def test_embed_examples_fused_matches_embed_examples_pallas(vggish):
    _, jp, enc, mel = vggish
    ref = np.asarray(embed_examples_pallas(jp, jnp.asarray(mel),
                                           dtype=jnp.float32, interpret=True))
    got = enc.embed_examples_fused(torch.from_numpy(mel), dtype=torch.float32)
    assert _rel(got.numpy(), ref) <= K3_RTOL["float32"]


def test_vggish_conv_plain_rounds_after_the_bias_and_pools_after_the_cast():
    """One layer in bf16 against the Pallas ``_conv3x3_relu`` + ``_pool2``
    arithmetic written out in numpy (f32 sums of bf16-rounded operands)."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 4, 6, 8).astype(np.float32)
    w = (rng.randn(3, 3, 8, 128) * 0.3).astype(np.float32)
    b = rng.randn(128).astype(np.float32)

    def bf16(a):
        return torch.from_numpy(a).to(torch.bfloat16).float().numpy()
    xp = np.pad(bf16(x), ((0, 0), (1, 1), (1, 1), (0, 0)))
    acc = sum(xp[:, ky:ky + 4, kx:kx + 6] @ bf16(w)[ky, kx]
              for ky in range(3) for kx in range(3))
    y = bf16(np.maximum(acc + b, 0.0))
    ref = y.reshape(2, 2, 2, 3, 2, 128).max(axis=(2, 4))
    got = V.vggish_conv_plain(torch.from_numpy(x).to(torch.bfloat16),
                              torch.from_numpy(w), torch.from_numpy(b),
                              pool=True, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 2, 3, 128)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2 ** -7)


# -------------------------------------------------------------------- int8

def _jax_int8_layer(x, w, b, pool, scale):
    """The quantize, int8 conv and epilogue of ``embed_examples_int8`` for
    one layer, in f32 (the JAX package's formula, op by op)."""
    sw = jnp.max(jnp.abs(w), axis=(0, 1, 2)) / 127.0
    wq = jnp.round(w / jnp.maximum(sw, 1e-12)).astype(jnp.int8)
    if scale is not None:
        sx = scale
        xq = jnp.round(jnp.clip(x / sx, 0.0, 127.0)).astype(jnp.int8)
    else:
        sx = jnp.maximum(jnp.max(x, axis=(1, 2, 3), keepdims=True),
                         1e-6) / 127.0
        xq = jnp.round(x / sx).astype(jnp.int8)
    yi = jax.lax.conv_general_dilated(
        xq, wq, window_strides=(1, 1), padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    y = jax.nn.relu(yi.astype(jnp.float32) * (sx * sw) + b)
    if pool:
        y = y.reshape(y.shape[0], y.shape[1] // 2, 2, y.shape[2] // 2, 2,
                      -1).max(axis=(2, 4))
    return wq, sw, xq, jnp.reshape(sx, (-1,)), yi, y


@pytest.mark.parametrize("layer,static", [(0, False), (1, True), (2, False),
                                          (4, True)])
def test_int8_layer_matches_jax_formula(vggish, layer, static):
    p, _, enc, _ = vggish
    H, W = {0: (48, 32), 1: (24, 16), 2: (24, 16), 4: (12, 8)}[layer]
    c = p["convs"][layer + 1]
    cin = c["w"].shape[2]
    x = np.maximum(np.random.RandomState(layer).randn(2, H, W, cin), 0.0
                   ).astype(np.float32)
    scale = 0.02 if static else None
    pool = V.POOLS[layer]
    jwq, jsw, jxq, jsx, jyi, jy = _jax_int8_layer(
        jnp.asarray(x), jnp.asarray(c["w"]), jnp.asarray(c["b"]), pool, scale)
    conv = enc.convs[layer + 1]
    wq, sw = V.quantize_weights(conv.w)
    xq, sx = V.quantize_activations(torch.from_numpy(x), scale)
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
    np.testing.assert_array_equal(sw.numpy(), np.asarray(jsw))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(sx.numpy(), np.broadcast_to(
        np.asarray(jsx, np.float32), (2,)))
    sums = V._conv3x3_sum(xq.double(), wq.double(), torch.matmul)
    np.testing.assert_array_equal(sums.numpy().astype(np.int64),
                                  np.asarray(jyi).astype(np.int64))
    got = V.conv3x3_relu_int8(xq, wq, sx, sw, conv.b, pool=pool,
                              dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jy))


@pytest.mark.parametrize("static", [False, True])
def test_int8_stack_matches_jax_exactly_from_one_conv1_output(vggish, static):
    """conv2..conv6 of ``embed_examples_int8``, both packages fed the JAX
    package's conv1 output: the same activations, bit for bit."""
    p, jp, enc, mel = vggish
    from mmqg_tpu.models import layers as JL
    x = jax.nn.relu(JL.conv2d(jp["convs"][0], jnp.asarray(mel)[..., None],
                              padding="SAME", dtype=jnp.float32,
                              out_dtype=jnp.float32))
    x = JL.maxpool2d(x, 2)
    scales = _calibrated(vggish) if static else (None,) * 5
    xt = torch.from_numpy(np.array(x))
    for i, pool in enumerate(V.POOLS):
        c = p["convs"][i + 1]
        x = _jax_int8_layer(x, jnp.asarray(c["w"]), jnp.asarray(c["b"]), pool,
                            scales[i])[-1]
        conv = enc.convs[i + 1]
        wq, sw = V.quantize_weights(conv.w)
        xq, sx = V.quantize_activations(xt, scales[i])
        xt = V.conv3x3_relu_int8(xq, wq, sx, sw, conv.b, pool=pool,
                                 dtype=torch.float32)
    assert float(xt.abs().max()) > 1.0
    np.testing.assert_array_equal(xt.numpy(), np.asarray(x))


_SCALES = {}


def _calibrated(vggish):
    if "jax" not in _SCALES:
        _, jp, _, mel = vggish
        _SCALES["jax"] = JAE.calibrate_int8_scales(jp, jnp.asarray(mel))
    return _SCALES["jax"]


def test_calibrate_int8_scales_matches_jax(vggish):
    _, _, enc, mel = vggish
    ref = _calibrated(vggish)
    got = enc.calibrate_int8_scales(torch.from_numpy(mel))
    assert len(got) == 5 and all(isinstance(s, float) for s in got)
    np.testing.assert_allclose(got, ref, rtol=1e-6)


@pytest.mark.parametrize("static", [False, True])
def test_embed_examples_int8_matches_jax(vggish, static):
    _, jp, enc, mel = vggish
    scales = _calibrated(vggish) if static else None
    ref = np.asarray(JAE.embed_examples_int8(jp, jnp.asarray(mel),
                                             dtype=jnp.float32,
                                             act_scales=scales))
    got = enc.embed_examples_int8(torch.from_numpy(mel), dtype=torch.float32,
                                  act_scales=scales)
    assert _rel(got.numpy(), ref) <= INT8_RTOL[static]


@pytest.mark.parametrize("static", [False, True])
def test_int8_zero_mel_is_finite(vggish, static):
    """All-zero mel (padded example slots) divides by no zero scale."""
    _, _, enc, _ = vggish
    scales = _calibrated(vggish) if static else None
    out = enc.embed_examples_int8(torch.zeros(2, 96, 64), dtype=torch.float32,
                                  act_scales=scales)
    assert bool(torch.isfinite(out).all())


def test_int8_embedding_does_not_depend_on_its_batch(vggish):
    """Per-example activation scales: an example embeds the same alone and
    beside others."""
    _, _, enc, mel = vggish
    mel = torch.from_numpy(mel)
    solo = enc.embed_examples_int8(mel[1:2], dtype=torch.float32)
    batched = enc.embed_examples_int8(mel, dtype=torch.float32)[1:2]
    # the JAX package's own band (tests/test_audio_int8.py): one quantization
    # flip would move it ~1e-2; the library conv and matmuls alone, whose
    # sums vary with the batch, move it ~5e-6
    torch.testing.assert_close(solo, batched, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("route", [{}, {"int8": True},
                                   {"int8": True, "int8_scales": "calibrated"},
                                   {"use_kernel": True}])
def test_forward_routes_as_jax_apply(vggish, route):
    """``AudioEncoder.forward`` takes the tower JAX's ``apply`` takes: int8
    first, then K3 off the CPU (so the float tower on the CPU), else the
    float tower; masked past each row's example count."""
    _, jp, enc, mel = vggish
    kw = dict(route)
    if kw.get("int8_scales") == "calibrated":
        kw["int8_scales"] = _calibrated(vggish)
    jkw = {("use_pallas" if k == "use_kernel" else k): v
           for k, v in kw.items()}
    mels = mel.reshape(1, N_EX, 96, 64)
    lens = np.asarray([2], np.int32)
    ref = np.asarray(JAE.apply(jp, jnp.asarray(mels), jnp.asarray(lens),
                               dtype=jnp.float32, **jkw))
    got = enc(torch.from_numpy(mels), torch.from_numpy(lens),
              dtype=torch.float32, **kw)
    tol = (INT8_RTOL["int8_scales" in kw] if kw.get("int8") else
           K3_RTOL["float32"])
    assert _rel(got.numpy(), ref) <= tol
    np.testing.assert_array_equal(got[0, 2].numpy(), 0.0)


def test_encode_keeps_the_float_tower_on_the_cpu(tiny_config, monkeypatch):
    """``mc.audio_int8_serving`` is on by default; on the CPU encode still
    takes the float tower, as the JAX package's does."""
    mc, params, state = tiny_model(tiny_config, seed=2)
    mc = TQ.ModelConfig(**mc._asdict())
    assert mc.audio_int8_serving
    model = params_from_numpy(params, state)
    batch = torch_batch(tiny_batch(mc, B=2))
    ref, _, _ = TQ.encode(model, mc._replace(audio_int8_serving=False),
                          batch, dtype=torch.float32)

    def refuse(*a, **k):
        raise AssertionError("int8 tower taken on the CPU")
    monkeypatch.setattr(AudioEncoder, "embed_examples_int8", refuse)
    mem, _, _ = TQ.encode(model, mc, batch, dtype=torch.float32)
    torch.testing.assert_close(mem.enc_audio, ref.enc_audio, rtol=0, atol=0)


def test_pipeline_calibrate_audio_int8_matches_jax(tiny_config):
    mc, params, state = tiny_model(tiny_config, seed=3)
    words = ["<pad>", "<start>", "<end>"] + [f"w{i}" for i in range(3, 40)]
    vocab = {w: i for i, w in enumerate(words)}
    i2w = {str(i): w for i, w in enumerate(words)}
    rng = np.random.RandomState(4)
    rate = tiny_config.audio_sample_rate
    audio = [(rng.randn(rng.randint(rate, 3 * rate)) * 3000).astype(np.int16)
             for _ in range(3)]
    jax_pipe = JaxPipeline(tiny_config, mc, params, state, vocab, i2w)
    port = QGPipeline(tiny_config, TQ.ModelConfig(**mc._asdict()), params,
                      state, vocab, i2w, device="cpu")
    assert port.calibrate_audio_int8(audio) is port
    ref = jax_pipe.calibrate_audio_int8(audio).mc.audio_int8_scales
    got = port.mc.audio_int8_scales
    assert len(got) == 5
    np.testing.assert_allclose(got, ref, rtol=1e-6)
