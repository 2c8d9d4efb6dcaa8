"""The batchnorm epilogue kernel (``csrc/bn_epilogue.cu`` via
``mmqg_tpu_torch/ops/bn_epilogue.py``) against PyTorch's eval chain on the
same card tensors, bit for bit: bf16 and float32 conv outputs, every
residual kind, with and without the ReLU, each output, at the channel
counts of R(2+1)D-18's inference trunk (the padded ones read exactly 0
past the published channels); values that overflow, underflow or are not
numbers; and the wrapper's refusals. Every
test needs an NVIDIA GPU and nvcc and skips without them. The file imports
no JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_bn_epilogue_cuda.py
"""

import pytest
import torch

from mmqg_tpu_torch.models import layers as L
from mmqg_tpu_torch.ops import bn_epilogue as E

pytestmark = pytest.mark.cuda

# the trunk's channel counts, and the published ones under the padded
CHANNELS = (48, 64, 144, 232, 288, 464, 512, 928)
PUBLISHED = {48: 45, 232: 230, 464: 460, 928: 921}
# (cast to the conv output's dtype, keep the float32 value) of each output
# the trunk asks for
OUTPUTS = {"cast": (True, False), "keep": (False, True), "both": (True, True)}
DTYPES = {"bf16": torch.bfloat16, "float32": torch.float32}
# (B, T, H, W): ragged, so the last grid-stride pass is partial
SHAPE = (3, 5, 7, 9)


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


def _bits(t):
    return None if t is None else t.view(
        torch.int16 if t.element_size() == 2 else torch.int32)


def _same(got, want):
    """Equal bits wherever ``want`` is a number, NaN where it is not."""
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is None:
            continue
        assert g.dtype == w.dtype and g.shape == w.shape
        nan = torch.isnan(w)
        assert torch.equal(torch.isnan(g), nan)
        assert torch.equal(_bits(g)[~nan], _bits(w)[~nan])


def _scale_shift(C, published, g, dev):
    bn = L.BatchNorm(torch.randn(published, generator=g),
                     torch.randn(published, generator=g),
                     torch.randn(published, generator=g),
                     torch.rand(published, generator=g) + 0.5)
    return [t.to(dev) for t in bn.eval_scale_shift(C)]


def _outputs(out, dtype):
    cast, keep = OUTPUTS[out]
    return {"cast": dtype if cast else None, "keep": keep}


def _args(C, residual, dev, seed=0, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)
    published = PUBLISHED.get(C, C)

    def act(dtype):
        t = 3 * torch.randn(*SHAPE, C, generator=g)
        t[..., published:] = 0
        return t.to(dtype).to(dev)

    x = act(dtype)
    a, b = _scale_shift(C, published, g, dev)
    kw = {}
    if residual == "identity":
        kw = {"residual": act(torch.float32)}
    elif residual == "down":
        res_a, res_b = _scale_shift(C, published, g, dev)
        kw = {"residual": act(dtype), "res_a": res_a, "res_b": res_b}
    return x, a, b, kw


@pytest.mark.parametrize("out", list(OUTPUTS))
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
@pytest.mark.parametrize("residual", ["none", "identity", "down"])
@pytest.mark.parametrize("C", CHANNELS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_the_kernel_is_the_eval_chain_bit_for_bit(dev, dtype, C, residual,
                                                  relu, out):
    x, a, b, kw = _args(C, residual, dev, seed=C, dtype=DTYPES[dtype])
    kw.update(_outputs(out, x.dtype), relu=relu)
    before = E.bn_epilogue.launches
    got = E.bn_epilogue(x, a, b, **kw)
    assert E.bn_epilogue.launches == before + 1
    want = E.bn_epilogue_plain(x, a, b, **kw)
    _same(got, want)
    published = PUBLISHED.get(C, C)
    for t in got:
        if t is not None:
            assert not t[..., published:].any()


@pytest.mark.parametrize("residual", ["none", "identity", "down"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_special_values_round_as_the_eval_chain(dev, dtype, residual):
    """Infinities, NaN, signed zeros, values that overflow bf16 when cast
    and values below its least normal, in x, the residual and the scale."""
    x, a, b, kw = _args(64, residual, dev, seed=3, dtype=DTYPES[dtype])
    special = torch.tensor([float("inf"), -float("inf"), float("nan"), -0.0,
                            0.0, 3.0e38, -3.0e38, 1e-40, -1e-40, 65504.0],
                           device=dev)
    x.view(-1)[:special.numel()] = special.to(x.dtype)
    a[:4] = torch.tensor([0.0, 1e30, -1e-30, -0.0], device=dev)
    b[4:6] = torch.tensor([-0.0, 3.0e38], device=dev)
    if residual != "none":
        r = kw["residual"].view(-1)
        r[-special.numel():] = special.to(r.dtype)
        r[5:5 + special.numel()] = special.flip(0).to(r.dtype)
    kw.update(_outputs("both", x.dtype))
    for relu in (True, False):
        _same(E.bn_epilogue(x, a, b, relu=relu, **kw),
              E.bn_epilogue_plain(x, a, b, relu=relu, **kw))


def test_a_stage_one_sized_output_is_the_eval_chain(dev):
    """More vectors than one grid of resident blocks takes: the grid
    strides several times, and the channel group of each pass advances by
    the stride modulo C / 8 (144 channels: 18 groups)."""
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((2, 16, 56, 56, 144), generator=g, device=dev
                    ).to(torch.bfloat16)
    a, b = _scale_shift(144, 144, torch.Generator().manual_seed(6), dev)
    sc = torch.randn(x.shape, generator=g, device=dev)
    kw = {"relu": True, "residual": sc, "cast": torch.bfloat16, "keep": True}
    _same(E.bn_epilogue(x, a, b, **kw), E.bn_epilogue_plain(x, a, b, **kw))


@pytest.mark.parametrize("fault", ["non_contiguous", "channels_not_8",
                                   "float64_x", "float16_x",
                                   "residual_shape", "residual_dtype",
                                   "cast_float32", "needs_grad"])
def test_the_wrapper_refuses_what_the_kernel_cannot_take(dev, fault):
    x, a, b, kw = _args(64, "identity", dev)
    call = {"relu": True, "cast": torch.bfloat16, "keep": True, **kw}
    if fault == "non_contiguous":
        x = x.transpose(1, 2)
        call["residual"] = call["residual"].transpose(1, 2)
    elif fault == "channels_not_8":
        x, a, b = x[..., :60].contiguous(), a[:60], b[:60]
        call["residual"] = call["residual"][..., :60].contiguous()
    elif fault == "float64_x":
        x = x.double()
    elif fault == "float16_x":
        x = x.half()
    elif fault == "residual_shape":
        call["residual"] = call["residual"][:1].contiguous()
    elif fault == "residual_dtype":
        call["residual"] = call["residual"].to(torch.bfloat16)
    elif fault == "cast_float32":
        call["cast"] = torch.float32
    else:
        a.requires_grad_(True)
    before = E.bn_epilogue.launches
    with pytest.raises(ValueError, match="bn_epilogue"):
        E.bn_epilogue(x, a, b, **call)
    assert E.bn_epilogue.launches == before
