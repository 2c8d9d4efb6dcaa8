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


# (B, T, In, H, forced route or None, the route the call must take): the
# sweep at the encoders' width (In 300 and 1000), a ragged B that crosses a
# 16-row tile (at H=256: 32 x 3 blocks, all resident), one step, narrow H;
# batches larger than one grid of resident blocks, run in row chunks (H=1024
# at B=20: 128 x 2 blocks; B=130 at H=512: 64 x 9); the per-step route
# forced at a shape the sweep takes; and H=2048, where no row of the sweep's
# 256 column blocks can be resident, so the per-step route runs (its
# contraction staged in slices)
LSTM_ROUTE_CASES = [(20, 37, 300, 64, None, "persistent"),
                    (33, 1, 300, 64, None, "persistent"),
                    (32, 17, 300, 512, None, "persistent"),
                    (32, 17, 1000, 512, None, "persistent"),
                    (33, 17, 300, 256, None, "persistent"),
                    (5, 1, 300, 512, None, "persistent"),
                    (20, 5, 72, 1024, None, "persistent"),
                    (130, 5, 72, 512, None, "persistent"),
                    (32, 17, 300, 512, "per_step", "per_step"),
                    (20, 5, 72, 2048, None, "per_step"),
                    (32, 5, 72, 2048, None, "per_step")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,In,H,force,route", LSTM_ROUTE_CASES)
def test_lstm_seq_kernel_matches_plain(dev, dtype, B, T, In, H, force,
                                       route):
    args = _lstm_args(dev, B=B, T=T, In=In, H=H)
    before = lstm_seq.launches, dict(lstm_seq.routes)
    got = lstm_seq(*args, dtype=dtype, force_route=force)
    assert lstm_seq.launches == before[0] + 1
    assert {k: v - before[1][k] for k, v in lstm_seq.routes.items()} == {
        "persistent": int(route == "persistent"),
        "per_step": int(route == "per_step")}
    ref = lstm_seq_plain(*args, dtype=dtype)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert float((g - r).abs().max()) <= K1_TOL[dtype]


def test_lstm_seq_refused_cooperative_launch_raises(dev):
    """The whole batch forced into one cooperative launch where its blocks
    cannot all be resident: the device refuses it and the wrapper raises."""
    args = _lstm_args(dev, B=20, T=5, In=72, H=1024)
    with pytest.raises(RuntimeError, match="mmqg_lstm_seq: CUDA error"):
        lstm_seq(*args, dtype=torch.float32, force_route="persistent")


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


def _attn_check(args):
    """K2 kernel vs plain at 1e-5 (both compute in f32 from the same
    operands); the call must count one launch."""
    before = trimodal_attention.launches
    got = trimodal_attention(*args)
    assert trimodal_attention.launches == before + 1
    ref = trimodal_attention_plain(*args)
    torch.cuda.synchronize()
    for g, r in zip(got[:3], ref[:3]):
        assert float((g - r).abs().max()) <= 1e-5
    for k in ref[3]:
        assert float((got[3][k] - ref[3][k]).abs().max()) <= 1e-5
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_trimodal_attention_kernel_matches_plain(dev, dtype):
    _attn_check(_attn_args(dev, dtype))


# the flagship's shapes (Dq 812, L 283 / 101 / 101, H 512 / 512 / 128);
# lengths: random, all 1, all L, and L - 3 (not a multiple of the 16-position
# chunk). W is scaled by 1 / sqrt(Dq), as chip_smoke.py's K2 phase does, so
# the scores are O(1) as the model's are: at unit W their spread (~28) makes
# each softmax near one-hot, and the f32 sums' order alone then moves a
# context by ~1e-4.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,lens", [(1, "random"), (32, "random"),
                                    (33, "random"), (128, "random"),
                                    (32, "one"), (33, "full"),
                                    (32, "ragged")])
def test_trimodal_attention_tiled_at_the_flagship_shapes(dev, dtype, B, lens):
    args = list(_attn_args(dev, dtype, B=B, Dq=812, Lt=283, La=101, Ht=512,
                           Hv=512, Ha=128, seed=B))
    args[0] = (args[0].float() / np.sqrt(812)).to(dtype)
    for i, L in zip((6, 7, 8), (283, 101, 101)):
        if lens != "random":
            n = {"one": 1, "full": L, "ragged": L - 3}[lens]
            args[i] = torch.full((B,), n, dtype=torch.int32, device=dev)
    got = _attn_check(args)
    again = trimodal_attention(*args)  # the arrival counters were left zero
    torch.cuda.synchronize()
    for g, a in zip(got[:3], again[:3]):
        assert torch.equal(g, a)


def test_trimodal_attention_kernel_rejects_mixed_dtypes(dev):
    args = list(_attn_args(dev, torch.bfloat16))
    args[3] = args[3].float()   # f32 text memory with a bf16 query
    with pytest.raises(ValueError, match="enc_text"):
        trimodal_attention(*args)
    args = list(_attn_args(dev, torch.bfloat16, Dq=42))
    with pytest.raises(ValueError, match="Dq % 4"):
        trimodal_attention(*args)


# K4, max |kernel - plain| of the forward, and of each gradient over its
# max |plain|. f32: summation order over B*T rows; bf16: the forward as K1
# (5e-3), gradients 2e-2 (da is rounded to bf16 before every product;
# chip_smoke.K4_FWD_TOL and K4_GRAD_TOL)
K4_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (5e-3, 2e-2)}


def _k4_check(dev, B, T, In, H, dtype, seed=3, force=None):
    """Forward + backward kernels vs plain at one shape; returns the
    forward and the backward routes the call took."""
    rng = np.random.RandomState(seed)

    def t(*shape, s=1.0):
        return torch.from_numpy((rng.randn(*shape) * s).astype(
            np.float32)).to(dev)
    args = [t(In, 4 * H, s=In ** -0.5), t(H, 4 * H, s=H ** -0.5),
            t(4 * H, s=0.1), t(B, T, In), t(B, H, s=0.5), t(B, H, s=0.5)]
    cots = [t(B, T, H), t(B, T, H), t(B, H), t(B, H)]
    leaves = [a.clone().requires_grad_(True) for a in args]
    before = (lstm_layer_train.fwd_launches, lstm_layer_train.bwd_launches,
              dict(lstm_layer_train.fwd_routes),
              dict(lstm_layer_train.bwd_routes))
    outs = lstm_layer_train(*leaves, dtype, force_route=force)
    torch.autograd.backward(outs, cots)
    assert (lstm_layer_train.fwd_launches,
            lstm_layer_train.bwd_launches) == (before[0] + 1, before[1] + 1)
    routes = [{k: v - was[k] for k, v in now.items()}
              for now, was in ((lstm_layer_train.fwd_routes, before[2]),
                               (lstm_layer_train.bwd_routes, before[3]))]
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


ONE = {"persistent": 1, "per_step": 0}
STEP = {"persistent": 0, "per_step": 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,In,H,force", [
    (5, 1, 300, 512, None), (32, 17, 300, 512, None),
    (32, 17, 1000, 512, None), (33, 17, 300, 256, None),
    (8, 9, 1000, 512, None), (32, 17, 300, 512, "per_step")])
def test_lstm_layer_train_backward_at_the_encoders_width(dev, B, T, In, H,
                                                         dtype, force):
    """The persistent sweeps, forward and backward, and the tensor-core
    GEMMs in bf16 at H=512: one step (the barriers' edge), In = 300 and
    1000, a ragged B that crosses a 16-row tile (H=256); the forward forced
    onto the per-step route, feeding the same backward."""
    fwd, bwd = _k4_check(dev, B, T, In, H, dtype, force=force)
    assert (fwd, bwd) == (STEP if force else ONE, ONE)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H", [(20, 1024), (130, 512)])
def test_lstm_layer_train_backward_per_step_route(dev, dtype, B, H):
    """Shapes whose backward sweep cannot be resident (H=1024 at B=20:
    128 x 2 blocks; B=130 at H=512: 64 x 9): the backward takes the
    per-step route, which writes the same da (and its bf16 copy for the
    GEMMs); the forward's sweep runs in row chunks."""
    assert _k4_check(dev, B, 5, 72, H, dtype) == [ONE, STEP]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [20, 32])
def test_lstm_layer_train_at_h2048_steps_both_ways(dev, dtype, B):
    """H=2048: neither sweep can hold a row of its 256 column blocks (and
    the f32 slices of Wh exceed shared memory), so the forward and the
    backward take the per-step routes, which stage the contraction in
    slices."""
    assert _k4_check(dev, B, 5, 72, 2048, dtype) == [STEP, STEP]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_layer_train_backward_per_step_route_at_b128(dev, dtype):
    """B=128 at the encoders' width: the forward's sweep runs in row
    chunks, the backward's 64 x 8 blocks cannot all be resident and it
    steps."""
    assert _k4_check(dev, 128, 17, 300, 512, dtype) == [ONE, STEP]


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


# the s8 tensor-core kernel: every Cin of VGGish (64: a K slice spans two
# taps), pool on and off, dynamic and static scales, N=3 at 12 x 10 (120
# positions an example: M tiles straddle examples); bit for bit
@pytest.mark.parametrize("Cin,Cout", [(64, 128), (128, 256), (256, 256),
                                      (512, 128)])
@pytest.mark.parametrize("pool", [True, False])
@pytest.mark.parametrize("static", [False, True])
def test_vggish_conv_int8_wgmma_matches_plain_exactly(dev, Cin, Cout, pool,
                                                      static):
    args = _int8_layer_args(dev, Cin=Cin, Cout=Cout, static=static)
    before = V.conv3x3_relu_int8.launches
    for dtype in (torch.bfloat16, torch.float32):
        got = V.conv3x3_relu_int8(*args, pool=pool, dtype=dtype)
        ref = V.conv3x3_relu_int8_plain(*args, pool=pool, dtype=dtype)
        torch.cuda.synchronize()
        assert float(ref.abs().max()) > 0
        assert torch.equal(got, ref)
    assert V.conv3x3_relu_int8.launches == before + 2


@pytest.mark.parametrize("N,H,W", [(1, 8, 8), (37, 12, 8), (3, 12, 10)])
@pytest.mark.parametrize("pool", [True, False])
@pytest.mark.parametrize("static", [False, True])
def test_vggish_conv_int8_quant_matches_plain_exactly(dev, N, H, W, pool,
                                                      static):
    """The conv with the next layer's quantize fused (the epilogue's int8
    under static scales; the folded max + quantize_s8 under dynamic ones)
    against the plain conv and quantize_activations: identical int8 values
    and identical scales."""
    args = _int8_layer_args(dev, N=N, H=H, W=W, Cin=128, Cout=128,
                            static=static)
    scale = 0.05 if static else None
    for dtype in (torch.bfloat16, torch.float32):
        before = V.conv3x3_relu_int8.launches, V.quantize_s8.launches
        xq, sx = V.conv3x3_relu_int8_quant(*args, pool=pool, dtype=dtype,
                                           next_scale=scale)
        assert (V.conv3x3_relu_int8.launches, V.quantize_s8.launches) == (
            before[0] + 1, before[1] + int(not static))
        rq, rs = V.quantize_activations(V.conv3x3_relu_int8_plain(
            *args, pool=pool, dtype=dtype), scale)
        torch.cuda.synchronize()
        assert xq.dtype == torch.int8 and int(rq.max()) > 0
        assert torch.equal(xq, rq) and torch.equal(sx, rs)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("static", [False, True])
def test_quantize_s8_matches_quantize_activations(dev, dtype, static):
    """conv2's input quantize (max taken in the kernel) on values whose
    quotients fall on .5 (x = k / 4 with sx = 0.5: max 63.5 / 127), and on
    random ones."""
    k = torch.arange(256, device=dev) % 255   # each example: 0 .. 63.5
    halves = (k.float() / 4).to(dtype).reshape(1, 16, 16, 1).expand(
        4, 16, 16, 1).contiguous()
    rand = torch.relu(torch.randn(5, 6, 4, 64, device=dev)).to(dtype)
    for x in (halves, rand):
        scale = 0.5 if static else None
        got = V.quantize_s8(x, scale)
        ref = V.quantize_activations(x, scale)
        torch.cuda.synchronize()
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert float(V.quantize_activations(halves)[1][0]) == 0.5


def test_embed_examples_int8_on_the_card_matches_its_plain_layers(dev):
    """The tower's int8 stack on the card (quantize_s8 + four fused
    conv3x3_relu_int8_quant + conv3x3_relu_int8) equals the CPU's plain
    layers fed the same conv1 output, dynamic and static."""
    convs = _vggish_convs(dev)
    mel = torch.from_numpy((np.random.RandomState(9).randn(3, 96, 64) * 2
                            ).astype(np.float32)).to(dev)
    x1 = V.conv1_pool(convs, mel, torch.float32)
    for scales in ((None,) * 5, (0.05, 0.05, 0.1, 0.1, 0.2)):
        xq, sx = V.quantize_s8(x1, scales[0])
        cq, cs = V.quantize_activations(x1.cpu(), scales[0])
        for i, (c, pool) in enumerate(zip(convs[1:], V.POOLS)):
            wq, sw = V.quantize_weights(c.w)
            cargs = (wq.cpu(), sw.cpu(), c.b.cpu())
            if i < 4:
                xq, sx = V.conv3x3_relu_int8_quant(
                    xq, wq, sx, sw, c.b, pool=pool, dtype=torch.float32,
                    next_scale=scales[i + 1])
                cq, cs = V.conv3x3_relu_int8_quant(
                    cq, cargs[0], cs, cargs[1], cargs[2], pool=pool,
                    dtype=torch.float32, next_scale=scales[i + 1])
                assert torch.equal(xq.cpu(), cq) and torch.equal(sx.cpu(), cs)
            else:
                y = V.conv3x3_relu_int8(xq, wq, sx, sw, c.b, pool=pool,
                                        dtype=torch.float32)
                ref = V.conv3x3_relu_int8(cq, cargs[0], cs, cargs[1],
                                          cargs[2], pool=pool,
                                          dtype=torch.float32)
                assert float(ref.abs().max()) > 0
                assert torch.equal(y.cpu(), ref)


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
