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
from mmqg_tpu_torch.ops.lstm_train import (lstm_layer_train,
                                           lstm_train_bwd_plain,
                                           lstm_train_fwd_plain)
from mmqg_tpu_torch.models import layers as L
from mmqg_tpu_torch.models.audio_encoder import BLOCKS
from mmqg_tpu_torch.ops import vggish as V

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


# K4, max |kernel - plain| of the forward, and of each gradient over its
# max |plain|. f32: summation order over B*T rows; bf16: the forward as K1
# (5e-3), gradients 2e-2 (da is rounded to bf16 before every product;
# chip_smoke.K4_FWD_TOL and K4_GRAD_TOL)
K4_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (5e-3, 2e-2)}


def _k4_check(dev, B, T, In, H, dtype, seed=3):
    """Forward + backward kernels vs plain at one shape; returns the
    backward routes the call took."""
    rng = np.random.RandomState(seed)

    def t(*shape, s=1.0):
        return torch.from_numpy((rng.randn(*shape) * s).astype(
            np.float32)).to(dev)
    args = [t(In, 4 * H, s=In ** -0.5), t(H, 4 * H, s=H ** -0.5),
            t(4 * H, s=0.1), t(B, T, In), t(B, H, s=0.5), t(B, H, s=0.5)]
    cots = [t(B, T, H), t(B, T, H), t(B, H), t(B, H)]
    leaves = [a.clone().requires_grad_(True) for a in args]
    before = (lstm_layer_train.fwd_launches, lstm_layer_train.bwd_launches,
              dict(lstm_layer_train.bwd_routes))
    outs = lstm_layer_train(*leaves, dtype)
    torch.autograd.backward(outs, cots)
    assert (lstm_layer_train.fwd_launches,
            lstm_layer_train.bwd_launches) == (before[0] + 1, before[1] + 1)
    routes = {k: v - before[2][k]
              for k, v in lstm_layer_train.bwd_routes.items()}
    out, cseq, gates, hT, cT = lstm_train_fwd_plain(*args, dtype)
    ref = lstm_train_bwd_plain(args[0], args[1], args[3], args[4], args[5],
                               out, cseq, gates, *cots, dtype)
    torch.cuda.synchronize()
    fwd_tol, grad_rtol = K4_TOL[dtype]
    for g, r in zip(outs, (out, cseq, hT, cT)):
        assert float((g.detach() - r).abs().max()) <= fwd_tol
    got = [leaves[i].grad for i in (0, 1, 2, 3, 4, 5)]  # dwx dwh db dx dh0 dc0
    for name, g, r in zip(("dwx", "dwh", "db", "dx", "dh0", "dc0"), got, ref):
        err = float((g - r).abs().max())
        assert err <= grad_rtol * float(r.abs().max()), (name, err)
    return routes


@pytest.mark.parametrize("B,T,In,H", [(20, 37, 300, 64), (33, 1, 24, 8),
                                      (5, 9, 72, 128)])
def test_lstm_layer_train_kernels_match_plain(dev, B, T, In, H):
    _k4_check(dev, B, T, In, H, torch.float32, seed=2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,In,H", [(5, 1, 300, 512), (32, 17, 300, 512),
                                      (8, 9, 1000, 512)])
def test_lstm_layer_train_backward_at_the_encoders_width(dev, B, T, In, H,
                                                         dtype):
    """The persistent sweep and the gradient GEMMs (tensor cores in bf16)
    at H=512: one step (the barrier's edge), ragged B and In = 300."""
    routes = _k4_check(dev, B, T, In, H, dtype)
    assert routes == {"persistent": 1, "per_step": 0}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_layer_train_backward_per_step_route(dev, dtype):
    """H=1024 at B=20 needs 128 x 2 sweep blocks, more than can be
    resident: the wrapper takes the per-step route, which writes the same
    da (and its bf16 copy for the GEMMs)."""
    routes = _k4_check(dev, 20, 5, 72, 1024, dtype)
    assert routes == {"persistent": 0, "per_step": 1}


def test_lstm_layer_train_kernel_rejects_what_it_cannot_take(dev):
    wx, wh, b = (torch.zeros(8, 4 * 60, device=dev),
                 torch.zeros(60, 4 * 60, device=dev),
                 torch.zeros(4 * 60, device=dev))
    xs, z = torch.zeros(2, 3, 8, device=dev), torch.zeros(2, 60, device=dev)
    with pytest.raises(ValueError, match="H % 8"):
        lstm_layer_train(wx, wh, b, xs, z, z)
    with pytest.raises(ValueError, match="compute dtype"):
        lstm_layer_train(wx[:, :32], wh[:8, :32], b[:32], xs,
                         z[:, :8], z[:, :8], torch.float16)


# K3, max |kernel - plain| / max |plain|: f32 differs only in summation
# order; bf16 rounds every activation, so an order-induced flip moves one
# value by a bf16 ulp and later layers carry it (see chip_smoke.K3_RTOL)
K3_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _vggish_convs(dev, seed=0):
    """VGGish's six convs at full width, He-scaled so the signal lasts."""
    rng = np.random.RandomState(seed)
    convs, c_in = [], 1
    for c_out, reps in BLOCKS:
        for _ in range(reps):
            w = rng.randn(3, 3, c_in, c_out) * np.sqrt(2.0 / (9 * c_in))
            convs.append(L.Conv2d(
                torch.from_numpy(w.astype(np.float32)).to(dev),
                torch.from_numpy((rng.randn(c_out) * 0.05).astype(
                    np.float32)).to(dev)))
            c_in = c_out
    return convs


@pytest.mark.parametrize("dtype,N", [(torch.float32, 3),
                                     (torch.bfloat16, 3), (torch.float32, 1),
                                     (torch.bfloat16, 1),
                                     (torch.bfloat16, 37)])
def test_vggish_features_kernel_matches_plain(dev, dtype, N):
    convs = _vggish_convs(dev)
    mel = torch.from_numpy((np.random.RandomState(N).randn(N, 96, 64) * 2
                            ).astype(np.float32)).to(dev)
    before = V.vggish_conv.launches
    got = V.vggish_features(convs, mel, dtype=dtype)
    assert V.vggish_conv.launches == before + 5
    ref = V.vggish_features_plain(convs, mel, dtype=dtype)
    torch.cuda.synchronize()
    assert got.shape == (N, 12288) and got.dtype == torch.float32
    scale = float(ref.abs().max())
    assert scale > 1.0
    assert float((got - ref).abs().max()) <= K3_RTOL[dtype] * scale


def _int8_layer_args(dev, N=3, H=12, W=10, Cin=64, Cout=256, static=False):
    """Ragged sizes: W=10 is not a multiple of the kernel's 8-wide tile."""
    rng = np.random.RandomState(H * W + Cin)
    x = torch.from_numpy(np.maximum(rng.randn(N, H, W, Cin), 0).astype(
        np.float32)).to(dev)
    w = torch.from_numpy((rng.randn(3, 3, Cin, Cout) * 0.05).astype(
        np.float32)).to(dev)
    b = torch.from_numpy((rng.randn(Cout) * 0.1).astype(np.float32)).to(dev)
    wq, sw = V.quantize_weights(w)
    xq, sx = V.quantize_activations(x, 0.02 if static else None)
    return xq, wq, sx, sw, b


@pytest.mark.parametrize("pool,dtype,static",
                         [(True, torch.bfloat16, False),
                          (False, torch.float32, True),
                          (True, torch.float32, False)])
def test_vggish_conv_int8_kernel_matches_plain_exactly(dev, pool, dtype,
                                                       static):
    args = _int8_layer_args(dev, static=static)
    before = V.conv3x3_relu_int8.launches
    got = V.conv3x3_relu_int8(*args, pool=pool, dtype=dtype)
    assert V.conv3x3_relu_int8.launches == before + 1
    ref = V.conv3x3_relu_int8_plain(*args, pool=pool, dtype=dtype)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == ref.shape
    assert float(ref.abs().max()) > 0
    assert torch.equal(got, ref)


def test_vggish_kernels_reject_what_they_cannot_take(dev):
    xq, wq, sx, sw, b = _int8_layer_args(dev, Cin=64, Cout=256)
    with pytest.raises(ValueError, match="Cout % 128"):
        V.conv3x3_relu_int8(xq, wq[..., :64].contiguous(), sx, sw[:64],
                            b[:64], pool=False)
    with pytest.raises(ValueError, match="Cin % 32"):
        V.conv3x3_relu_int8(xq[..., :48].contiguous(),
                            wq[:, :, :48].contiguous(), sx, sw, b, pool=False)
    with pytest.raises(ValueError, match="sx"):
        V.conv3x3_relu_int8(xq, wq, sx.double(), sw, b, pool=False)
    with pytest.raises(ValueError, match="even H and W"):
        V.conv3x3_relu_int8(xq[:, :, :9].contiguous(), wq, sx, sw, b,
                            pool=True)
    x = torch.zeros(2, 8, 8, 64, device=dev)
    w = torch.zeros(3, 3, 64, 128, device=dev)
    # the bf16 tensor-core kernel takes 64 channels of a tap at a time
    with pytest.raises(ValueError, match="Cin % 64"):
        V.vggish_conv(x[..., :40].bfloat16().contiguous(),
                      w[:, :, :40].contiguous(), b[:128], pool=True,
                      dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="x is"):
        V.vggish_conv(x, w, b[:128], pool=True, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        V.vggish_conv(x.transpose(1, 2), w, b[:128], pool=True,
                      dtype=torch.float32)
