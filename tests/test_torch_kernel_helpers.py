"""The Python side of the K3 and K4 kernels, on the CPU: K3's K-major
weight packing and K4's dWh operand ``h_prev_seq`` against their plain
meaning, and that K4's CPU route (the plain versions) counts no launch and
no sweep route."""

import numpy as np
import pytest
import torch

from mmqg_tpu_torch.ops.lstm_train import h_prev_seq, lstm_layer_train
from mmqg_tpu_torch.ops.vggish import pack_weights_kmajor


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_weights_kmajor_rows_are_output_channels(dtype):
    """Row co of the packed (Cout, 3, 3, Cin) weights, flattened, is the
    GEMM's K = (tap, Cin) column of output channel co."""
    Cin, Cout = 5, 7
    w = torch.from_numpy(np.random.RandomState(1).randn(
        3, 3, Cin, Cout).astype(np.float32))
    got = pack_weights_kmajor(w, dtype)
    assert got.shape == (Cout, 3, 3, Cin) and got.dtype == dtype
    assert got.is_contiguous()
    flat = got.reshape(Cout, 9 * Cin)
    for co in range(Cout):
        for ky in range(3):
            for kx in range(3):
                for c in range(Cin):
                    k = (ky * 3 + kx) * Cin + c
                    assert flat[co, k] == w[ky, kx, c, co].to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 4])
def test_h_prev_seq_is_the_state_each_step_starts_from(dtype, T):
    rng = np.random.RandomState(T)
    B, H = 3, 8
    h0 = torch.from_numpy(rng.randn(B, H).astype(np.float32))
    out = torch.from_numpy(rng.randn(B, T, H).astype(np.float32))
    got = h_prev_seq(h0, out, dtype)
    assert got.shape == (B, T, H) and got.dtype == dtype
    for b in range(B):
        for t in range(T):
            want = h0[b] if t == 0 else out[b, t - 1]
            # rounded once, to nearest even, as the kernel's operand
            assert torch.equal(got[b, t], want.to(dtype))


def test_cpu_backward_counts_no_launch_and_no_route():
    rng = np.random.RandomState(0)
    B, T, In, H = 2, 3, 4, 8

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(
            np.float32)).requires_grad_(True)
    leaves = [t(In, 4 * H), t(H, 4 * H), t(4 * H), t(B, T, In), t(B, H),
              t(B, H)]
    before = (lstm_layer_train.fwd_launches, lstm_layer_train.bwd_launches,
              dict(lstm_layer_train.bwd_routes))
    out = lstm_layer_train(*leaves, torch.bfloat16)
    out[0].sum().backward()
    assert all(leaf.grad is not None for leaf in leaves)
    assert (lstm_layer_train.fwd_launches, lstm_layer_train.bwd_launches,
            lstm_layer_train.bwd_routes) == before
    assert set(before[2]) == {"persistent", "per_step"}
