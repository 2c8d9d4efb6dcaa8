"""The PyTorch port's CUDA kernels vs their plain PyTorch versions, on the
card. Every test here needs an NVIDIA GPU and nvcc (a CUDA kernel has no
CPU mode) and skips without them; ``chip_smoke.py`` runs the same checks at
the main path's shapes. The file imports no JAX, so it also runs on a
machine without it:

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from mmqg_tpu_torch.ops.attention import (trimodal_attention,
                                          trimodal_attention_plain)
from mmqg_tpu_torch.ops.lstm import lstm_seq, lstm_seq_plain

pytestmark = pytest.mark.cuda

# max |kernel - plain|: f32 differs only in summation order; bf16 rounds h
# before each Wh product, so one order-induced flip is a bf16 ulp that the
# recurrence carries (see chip_smoke.K1_TOL).
K1_TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-3}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from mmqg_tpu_torch.ops import _build
    try:
        _build.nvcc_path()
    except RuntimeError as e:
        pytest.skip(str(e))
    return torch.device("cuda")


def _lstm_args(dev, B=20, T=37, In=300, H=64, seed=0):
    rng = np.random.RandomState(seed)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)
    return (t(rng.randn(B, T, In)), t(rng.randn(In, 4 * H) / np.sqrt(In)),
            t(rng.randn(H, 4 * H) / np.sqrt(H)), t(rng.randn(4 * H)),
            t(rng.randn(B, H)), t(rng.randn(B, H)),
            torch.from_numpy(rng.randint(1, T + 1, B).astype(np.int32)).to(dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T", [(20, 37), (33, 1)])
def test_lstm_seq_kernel_matches_plain(dev, dtype, B, T):
    args = _lstm_args(dev, B=B, T=T)
    before = lstm_seq.launches
    got = lstm_seq(*args, dtype=dtype)
    assert lstm_seq.launches == before + 1
    ref = lstm_seq_plain(*args, dtype=dtype)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert float((g - r).abs().max()) <= K1_TOL[dtype]


def test_lstm_seq_kernel_rejects_what_it_cannot_take(dev):
    xs, wx, wh, b, h0, c0, lens = _lstm_args(dev, H=60)  # H % 8 != 0
    with pytest.raises(ValueError, match="H % 8"):
        lstm_seq(xs, wx, wh, b, h0, c0, lens)
    xs, wx, wh, b, h0, c0, lens = _lstm_args(dev)
    with pytest.raises(ValueError, match="lengths"):
        lstm_seq(xs, wx, wh, b, h0, c0, lens.long())
    with pytest.raises(ValueError, match="contiguous"):
        lstm_seq(xs, wx, wh, b, h0.t().contiguous().t(), c0, lens)


def _attn_args(dev, dtype, B=5, Dq=40, Lt=37, La=11, Ht=64, Hv=48, Ha=16,
               seed=1):
    rng = np.random.RandomState(seed)

    def t(a, dt=dtype):
        return torch.from_numpy(a.astype(np.float32)).to(dev, dt)
    lens = [torch.from_numpy(rng.randint(1, L + 1, B).astype(np.int32)).to(dev)
            for L in (Lt, La, La)]
    return (t(rng.randn(Lt + 2 * La, Dq)), t(rng.randn(Lt + 2 * La),
                                             torch.float32),
            t(rng.randn(B, Dq)), t(rng.randn(B, Lt, Ht)),
            t(rng.randn(B, La, Hv)), t(rng.randn(B, La, Ha)), *lens)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_trimodal_attention_kernel_matches_plain(dev, dtype):
    args = _attn_args(dev, dtype)
    before = trimodal_attention.launches
    got = trimodal_attention(*args)
    assert trimodal_attention.launches == before + 1
    ref = trimodal_attention_plain(*args)
    torch.cuda.synchronize()
    for g, r in zip(got[:3], ref[:3]):
        assert float((g - r).abs().max()) <= 1e-5
    for k in ref[3]:
        assert float((got[3][k] - ref[3][k]).abs().max()) <= 1e-5


def test_trimodal_attention_kernel_rejects_mixed_dtypes(dev):
    args = list(_attn_args(dev, torch.bfloat16))
    args[3] = args[3].float()   # f32 text memory with a bf16 query
    with pytest.raises(ValueError, match="enc_text"):
        trimodal_attention(*args)
