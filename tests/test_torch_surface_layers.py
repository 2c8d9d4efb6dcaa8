"""The layers' and front ends' keywords that complete the port's surface,
against the JAX package on the CPU, f32:

* ``layers.conv2d(stride=)`` at strides 1, 2 and 3, VALID and SAME (XLA's
  SAME pads the odd element after), within 1e-6;
* ``layers.maxpool2d(stride=)``: overlapping windows (window 3, stride 2;
  window 2, stride 1), a stride above the window, and the stride-=-window
  crop path, forward and gradient within 1e-6;
* ``layers.BatchNorm.eval_scale_shift`` for up to 7 channels more than
  the batchnorm's (a conv padded to a multiple of 8), through the eval
  epilogue's plain path: its own channels bit for bit as unpadded, the
  rest exactly 0;
* ``layers.lstm_dims``, ``lstm_zero_state`` and ``lstm_scan``'s dropout
  (rate 0 is JAX's scan within 1e-6; with a generator, dropout between the
  layers as ``lstm_step`` draws it: JAX's threefry masks are not
  reproduced, only where they apply);
* ``frontends.audio_num_examples(sample_rate=)``, accepted and unused as
  in JAX; ``prepare_frames(frames_u8=, dtype=)``; ``log_mel_examples(
  spec_dtype=)``;
* ``multihost.initialize_multihost(coordinator_address=)``."""

import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmqg_tpu.models import frontends as JF
from mmqg_tpu.models import layers as JL
from mmqg_tpu_torch.models import frontends as F
from mmqg_tpu_torch.models import layers as L
from mmqg_tpu_torch.ops.bn_epilogue import bn_epilogue_plain

torch.set_num_threads(1)
TOL = 1e-6


def _conv_args(k, cin=3, cout=4, shape=(2, 11, 9), seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape, cin).astype(np.float32)
    w = (rng.randn(k, k, cin, cout) / np.sqrt(k * k * cin)).astype(
        np.float32)
    b = rng.randn(cout).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("padding", ["VALID", "SAME"])
@pytest.mark.parametrize("k", [3, 2])
@pytest.mark.parametrize("stride", [1, 2, 3])
def test_conv2d_stride_matches_jax(stride, k, padding):
    x, w, b = _conv_args(k)
    ref = np.asarray(JL.conv2d({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                               jnp.asarray(x), stride=stride,
                               padding=padding, dtype=jnp.float32))
    got = L.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                   torch.from_numpy(b), stride=stride, padding=padding,
                   dtype=torch.float32).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


def test_conv2d_refuses_an_unknown_padding():
    x, w, b = (torch.from_numpy(a) for a in _conv_args(3))
    with pytest.raises(ValueError, match="padding"):
        L.conv2d(x, w, b, padding="FULL")


@pytest.mark.parametrize("window,stride", [(3, 2), (2, 1), (2, 3), (3, 3),
                                           (2, None)])
def test_maxpool2d_stride_matches_jax(window, stride):
    """Forward equal (a max is exact) and the gradient of a weighted sum
    within 1e-6: random values have no ties, so each window routes its
    cotangent to its one maximum on both sides, overlapping windows
    adding theirs."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 11, 8, 3).astype(np.float32)

    def jax_pool(a):
        return JL.maxpool2d(a, window, stride)
    ref = np.asarray(jax_pool(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = L.maxpool2d(xt, window, stride)
    np.testing.assert_array_equal(got.detach().numpy(), ref)
    cot = rng.randn(*ref.shape).astype(np.float32)
    (got * torch.from_numpy(cot)).sum().backward()
    jgrad = np.asarray(jax.grad(lambda a: (jax_pool(a) * cot).sum())(
        jnp.asarray(x)))
    np.testing.assert_allclose(xt.grad.numpy(), jgrad, rtol=0, atol=TOL)


def _lstm(seed=2, In=5, H=6, layers=3):
    rng = np.random.RandomState(seed)
    params = {"layers": []}
    torch_layers = []
    for li in range(layers):
        d = In if li == 0 else H
        wx = (rng.randn(d, 4 * H) / np.sqrt(d)).astype(np.float32)
        wh = (rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32)
        b = (rng.randn(4 * H) * 0.1).astype(np.float32)
        params["layers"].append({"wx": jnp.asarray(wx), "wh": jnp.asarray(wh),
                                 "b": jnp.asarray(b)})
        torch_layers.append(L.LSTMLayer(*(torch.from_numpy(a)
                                          for a in (wx, wh, b))))
    return params, L.LSTM(torch_layers)


def test_batchnorm_eval_all_zeroes_the_channels_padded_past_it():
    rng = np.random.RandomState(5)
    C = 13
    bn = L.BatchNorm(*(torch.from_numpy(a.astype(np.float32)) for a in (
        rng.randn(C), rng.randn(C), rng.randn(C), rng.rand(C) + 0.5)))
    for dtype in (torch.float32, torch.float64):
        x = torch.from_numpy(rng.randn(2, 3, 4, C)).to(dtype)
        for pad in (1, 3, 7):
            extra = torch.from_numpy(rng.randn(2, 3, 4, pad)).to(dtype)
            wide = torch.cat([x, extra], dim=-1)
            for relu in (False, True):
                _, got = bn_epilogue_plain(
                    wide, *bn.eval_scale_shift(C + pad), relu=relu)
                assert got.dtype == dtype and got.shape == wide.shape
                _, own = bn_epilogue_plain(x, *bn.eval_scale_shift(C),
                                           relu=relu)
                assert torch.equal(got[..., :C], own)
                assert torch.equal(got[..., C:], torch.zeros_like(extra))
    for width in (C - 1, C + 8):
        with pytest.raises(ValueError, match="channels"):
            bn.eval_scale_shift(width)


def test_lstm_dims_and_zero_state_match_jax():
    params, lstm = _lstm()
    assert L.lstm_dims(lstm) == JL.lstm_dims(params) == (3, 6)
    h, c = L.lstm_zero_state(3, 4, 6)
    jh, jc = JL.lstm_zero_state(3, 4, 6)
    for a, b in ((h, jh), (c, jc)):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert not a.any()
    assert L.lstm_zero_state(2, 1, 3, torch.bfloat16)[0].dtype \
        == torch.bfloat16


def test_lstm_scan_without_dropout_matches_jax():
    params, lstm = _lstm()
    xs = np.random.RandomState(3).randn(4, 7, 5).astype(np.float32)
    ref_out, (ref_h, ref_c) = JL.lstm_scan(params, jnp.asarray(xs),
                                           dtype=jnp.float32)
    gen = torch.Generator().manual_seed(0)
    for kw in ({}, {"dropout_rate": 0.0, "generator": gen},
               {"dropout_rate": 0.5}):
        out, (h, c) = L.lstm_scan(lstm, torch.from_numpy(xs),
                                  dtype=torch.float32, **kw)
        for a, b in ((out, ref_out), (h, ref_h), (c, ref_c)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=TOL)


def test_lstm_scan_drops_out_between_layers():
    """With a generator and a rate, each layer's output sequence but the
    last's is dropped out (a fresh mask from the generator, kept values
    scaled by 1 / (1 - rate)) before it feeds the next layer; the final
    state is each layer's own, before dropout."""
    params, lstm = _lstm()
    xs = torch.from_numpy(np.random.RandomState(4).randn(4, 7, 5).astype(
        np.float32))
    rate = 0.4
    out, (h, c) = L.lstm_scan(lstm, xs, dropout_rate=rate,
                              generator=torch.Generator().manual_seed(9),
                              dtype=torch.float32)
    gen = torch.Generator().manual_seed(9)
    seq, hs, cs = xs, [], []
    for li, layer in enumerate(lstm.layers):
        one = L.LSTM([layer])
        seq, (hl, cl) = L.lstm_scan(one, seq, dtype=torch.float32)
        hs.append(hl[0])
        cs.append(cl[0])
        if li < len(lstm.layers) - 1:
            seq = L.dropout(seq, rate, gen)
    torch.testing.assert_close(out, seq, rtol=0, atol=0)
    torch.testing.assert_close(h, torch.stack(hs), rtol=0, atol=0)
    torch.testing.assert_close(c, torch.stack(cs), rtol=0, atol=0)
    plain, _ = L.lstm_scan(lstm, xs, dtype=torch.float32)
    assert not torch.equal(out, plain)


def test_audio_num_examples_takes_and_ignores_sample_rate():
    lens = np.array([0, 399, 400, 15519, 15520, 16000 * 30, 10 ** 7],
                    np.int32)
    for rate in (16000, 44100):
        ref = np.asarray(JF.audio_num_examples(jnp.asarray(lens),
                                               sample_rate=rate))
        got = F.audio_num_examples(torch.from_numpy(lens), sample_rate=rate)
        np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(
            got.numpy(), F.audio_num_examples(torch.from_numpy(lens)).numpy())


def test_prepare_frames_dtype_and_keyword_match_jax():
    """``frames_u8=`` by name; f32 within the resize test's tolerance of
    JAX's; bf16 computed and returned in bf16 as JAX's, within one bf16
    step of JAX's bf16 result at its largest values (|x| < 4: 2^-6)."""
    x = np.random.RandomState(5).randint(0, 256, (1, 2, 20, 30, 3),
                                         np.uint8)
    ref32 = np.asarray(JF.prepare_frames(jnp.asarray(x), size=16))
    got32 = F.prepare_frames(frames_u8=torch.from_numpy(x), size=16,
                             dtype=torch.float32)
    assert got32.dtype == torch.float32
    np.testing.assert_allclose(got32.numpy(), ref32, rtol=0,
                               atol=TOL / 0.216989)
    ref16 = np.asarray(JF.prepare_frames(jnp.asarray(x), size=16,
                                         dtype=jnp.bfloat16)).astype(
        np.float32)
    got16 = F.prepare_frames(torch.from_numpy(x), size=16,
                             dtype=torch.bfloat16)
    assert got16.dtype == torch.bfloat16 and np.abs(ref16).max() < 4
    np.testing.assert_allclose(got16.float().numpy(), ref16, rtol=0,
                               atol=2 ** -6)


@pytest.mark.parametrize("spec_dtype", ["float32", "bfloat16"])
def test_log_mel_spec_dtype_matches_jax(spec_dtype):
    """The spectrogram kept in ``spec_dtype`` between the two products,
    JAX's within 1e-4 either way (the log of f32 sums, |log mel| <= 4.7);
    f32 is the default's result exactly."""
    rng = np.random.RandomState(6)
    pcm = (0.3 * rng.randn(2, 4000)).astype(np.float32)
    kw = dict(sample_rate=1600, window=64, hop=32, mel_bins=16,
              frames_per_example=16, max_examples=7)
    ref = np.asarray(JF.log_mel_examples(
        jnp.asarray(pcm), dtype=jnp.float32,
        spec_dtype=getattr(jnp, spec_dtype), **kw))
    got = F.log_mel_examples(torch.from_numpy(pcm), dtype=torch.float32,
                             spec_dtype=getattr(torch, spec_dtype), **kw)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)
    if spec_dtype == "float32":
        torch.testing.assert_close(got, F.log_mel_examples(
            torch.from_numpy(pcm), dtype=torch.float32, **kw), rtol=0, atol=0)


def test_initialize_multihost_takes_coordinator_address():
    """JAX's keyword: a one-process gloo group meets at the address."""
    import torch.distributed as dist

    from mmqg_tpu_torch.parallel import multihost as MH

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    MH.initialize_multihost(coordinator_address=f"localhost:{port}",
                            num_processes=1, process_id=0, device="cpu",
                            timeout_s=60)
    try:
        assert dist.is_initialized() and MH.world() == (0, 1)
        assert dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="coordinator"):
        MH.initialize_multihost(coordinator_address="localhost:1",
                                device="cpu")
