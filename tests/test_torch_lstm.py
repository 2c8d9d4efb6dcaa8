"""K1 (lstm_seq) and the LSTM layers of the PyTorch port vs the JAX package.

The port's plain version (what a CPU tensor runs) is held to the Pallas
kernel in interpret mode and to ``layers.lstm_scan`` + the latch, in f32 at
atol 1e-5. The CUDA kernel itself is compared with the plain version on the
card in tests/test_torch_kernels_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmqg_tpu.models import layers as JL
from mmqg_tpu.ops.lstm_pallas import lstm_layer_pallas, lstm_stack_pallas
from mmqg_tpu_torch.models import layers as L
from mmqg_tpu_torch.ops.lstm import lstm_seq, lstm_stack

torch.set_num_threads(1)
ATOL = 1e-5  # f32: the two packages differ only in summation order


def _lstm(In, H, NL, seed):
    params = jax.tree.map(np.asarray, JL.lstm_init(jax.random.PRNGKey(seed),
                                                   In, H, NL))
    port = L.LSTM([L.LSTMLayer(*(torch.tensor(l[k]) for k in
                                 ("wx", "wh", "b")))
                   for l in params["layers"]])
    return params, port


@pytest.mark.parametrize("lens", [[2, 5, 1], [5, 5, 5], [3, 1, 4]])
def test_lstm_seq_matches_pallas_interpret(lens):
    B, T, In, H = 3, 5, 4, 8
    params, port = _lstm(In, H, 1, seed=1)
    xs = np.random.RandomState(1).randn(B, T, In).astype(np.float32)
    h0 = np.random.RandomState(2).randn(B, H).astype(np.float32)
    c0 = np.random.RandomState(3).randn(B, H).astype(np.float32)
    lens = np.asarray(lens, np.int32)
    ref = lstm_layer_pallas(params["layers"][0], jnp.asarray(xs),
                            jnp.asarray(h0), jnp.asarray(c0),
                            jnp.asarray(lens), mask_output=True,
                            dtype=jnp.float32, interpret=True)
    layer = port.layers[0]
    got = lstm_seq(torch.from_numpy(xs), layer.wx, layer.wh, layer.b,
                   torch.from_numpy(h0), torch.from_numpy(c0),
                   torch.from_numpy(lens), dtype=torch.float32)
    for g, r, name in zip(got, ref, ("out", "h_last", "c_last")):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL,
                                   err_msg=name)
    np.testing.assert_array_equal(got[0][0, lens[0]:].numpy(), 0.0)


def test_lstm_seq_matches_scan_and_latch():
    """Oracle as in test_lstm_pallas: the latched state equals scanning
    each row's prefix alone; the output equals lstm_scan up to each row's
    length and is zero past it."""
    B, T, In, H = 3, 6, 5, 8
    params, port = _lstm(In, H, 1, seed=4)
    xs = np.random.RandomState(4).randn(B, T, In).astype(np.float32)
    lens = [2, 6, 1]
    layer = port.layers[0]
    z = torch.zeros(B, H)
    out, h, c = lstm_seq(torch.from_numpy(xs), layer.wx, layer.wh, layer.b,
                         z, z, torch.tensor(lens, dtype=torch.int32),
                         dtype=torch.float32)
    ref_out = np.asarray(JL.lstm_scan(params, jnp.asarray(xs),
                                      dtype=jnp.float32)[0])
    for b, n in enumerate(lens):
        np.testing.assert_allclose(out[b, :n].numpy(), ref_out[b, :n],
                                   atol=ATOL)
        np.testing.assert_array_equal(out[b, n:].numpy(), 0.0)
        _, (h_ref, c_ref) = JL.lstm_scan(params, jnp.asarray(xs[b:b + 1, :n]),
                                         dtype=jnp.float32)
        np.testing.assert_allclose(h[b].numpy(), np.asarray(h_ref[0, 0]),
                                   atol=ATOL)
        np.testing.assert_allclose(c[b].numpy(), np.asarray(c_ref[0, 0]),
                                   atol=ATOL)


def test_lstm_stack_matches_pallas_stack():
    B, T, In, H, NL = 2, 5, 4, 8, 3
    params, port = _lstm(In, H, NL, seed=2)
    xs = np.random.RandomState(2).randn(B, T, In).astype(np.float32)
    lens = np.asarray([3, 5], np.int32)
    ref_out, (ref_h, ref_c) = lstm_stack_pallas(
        params, jnp.asarray(xs), lengths=jnp.asarray(lens), mask_output=True,
        dtype=jnp.float32, interpret=True)
    out, (h, c) = lstm_stack(port, torch.from_numpy(xs),
                             torch.from_numpy(lens), dtype=torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), atol=ATOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(ref_c), atol=ATOL)


def test_lstm_seq_bf16_band():
    """bf16 operands, f32 state: the port rounds where JAX rounds, so the
    two agree to a few bf16 ulps carried through the recurrence."""
    B, T, In, H = 3, 5, 4, 8
    params, port = _lstm(In, H, 1, seed=5)
    xs = np.random.RandomState(5).randn(B, T, In).astype(np.float32)
    lens = np.asarray([5, 3, 2], np.int32)
    z = np.zeros((B, H), np.float32)
    ref = lstm_layer_pallas(params["layers"][0], jnp.asarray(xs),
                            jnp.asarray(z), jnp.asarray(z), jnp.asarray(lens),
                            mask_output=True, dtype=jnp.bfloat16,
                            interpret=True)
    layer = port.layers[0]
    got = lstm_seq(torch.from_numpy(xs), layer.wx, layer.wh, layer.b,
                   torch.from_numpy(z), torch.from_numpy(z),
                   torch.from_numpy(lens), dtype=torch.bfloat16)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-2)


def test_layers_step_and_scan_match_jax():
    B, T, In, H, NL = 2, 4, 6, 8, 2
    params, port = _lstm(In, H, NL, seed=3)
    rng = np.random.RandomState(3)
    xs = rng.randn(B, T, In).astype(np.float32)
    h0 = rng.randn(NL, B, H).astype(np.float32)
    c0 = rng.randn(NL, B, H).astype(np.float32)
    top_ref, (h_ref, c_ref) = JL.lstm_step(
        params, jnp.asarray(xs[:, 0]), (jnp.asarray(h0), jnp.asarray(c0)),
        dtype=jnp.float32)
    top, (h, c) = L.lstm_step(port, torch.from_numpy(xs[:, 0]),
                              (torch.from_numpy(h0), torch.from_numpy(c0)),
                              dtype=torch.float32)
    np.testing.assert_allclose(top.numpy(), np.asarray(top_ref), atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), atol=ATOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), atol=ATOL)
    seq_ref, (hs_ref, _) = JL.lstm_scan(params, jnp.asarray(xs),
                                        dtype=jnp.float32)
    seq, (hs, _) = L.lstm_scan(port, torch.from_numpy(xs),
                               dtype=torch.float32)
    np.testing.assert_allclose(seq.numpy(), np.asarray(seq_ref), atol=ATOL)
    np.testing.assert_allclose(hs.numpy(), np.asarray(hs_ref), atol=ATOL)


def test_lstm_seq_rejects_other_devices():
    x = torch.zeros(1, 2, 3, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        lstm_seq(x, x, x, x, x, x, x)
